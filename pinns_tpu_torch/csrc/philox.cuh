// Philox-4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's collocation draws: K3's tail (csrc/fused_step.cu) and K11, the
// generic step's draw (csrc/sampling.cu), both call it, and
// data/sampling.py::philox4x32_10 computes the same words on any device.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

}  // namespace
