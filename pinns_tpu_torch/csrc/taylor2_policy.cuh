// The bf16 stream policy of the Taylor-2 pass (pinns_tpu/ops/taylor.py::
// _StreamPolicy; the port's plain version is ops/taylor.py), shared by K6
// (csrc/taylor2.cu instantiated with kMixed) and its backward
// (csrc/taylor2_backward.cu), so that the backward recomputes exactly the
// forward's rounding.
//
// A quantized stream is stored in bf16 at every layer boundary and its dot
// multiplies the stored values by bf16(W) with float32 accumulation; under
// mixed_elementwise its dot output is rounded to bf16 too, and every
// elementwise op whose result type is bf16 (JAX's promotion: bf16 op bf16 is
// bf16, bf16 op f32 is f32) rounds again. Layer 0 consumes exact coordinates.
// Rounding is round-to-nearest-even (__float2bfloat16_rn), as torch's
// .to(bfloat16) and JAX's astype. The elementwise ops use __fmul_rn /
// __fadd_rn, so nvcc contracts none of them into an FMA the plain version
// does not do.

#pragma once

#include <cuda_bf16.h>

namespace {

struct Policy {
  bool qv, qd, qxx;  // stream quantized: value, x/t derivatives, xx
  bool me;           // mixed_elementwise
};

// The wrappers' policy word: 1 value quantized, 2 x/t derivatives quantized,
// 4 xx quantized, 8 mixed_elementwise.
inline Policy decode_policy(int word) {
  return Policy{(word & 1) != 0, (word & 2) != 0, (word & 4) != 0, (word & 8) != 0};
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rq(float v, bool q) { return q ? bf16r(v) : v; }

// Layer l's flags: which streams' dots take bf16 weights (w*) and which dot
// outputs are rounded (t*).
struct LayerQ {
  bool wv, wd, wxx, tv, td, txx;
  __device__ LayerQ(const Policy& q, int l)
      : wv(l > 0 && q.qv), wd(l > 0 && q.qd), wxx(l > 0 && q.qxx),
        tv(wv && q.me), td(wd && q.me), txx(wxx && q.me) {}
};

// The elementwise stage of a tanh layer, in the plain version's operation
// order (s'' = (-2 s) s', Hxx = (s'' Px) Px + s' Pxx), from the pre-
// activations after `act`: the tanh factors (s, s', s'') it used and the
// stored output streams (h, hx, ht, hxx).
__device__ __forceinline__ void policy_act(float p, float px, float pt, float pxx,
                                           const LayerQ& lq, const Policy& q, float& s,
                                           float& d1, float& d2, float& h, float& hx, float& ht,
                                           float& hxx) {
  const bool tv = lq.tv, tvd = lq.tv && lq.td;
  s = rq(tanhf(p), tv);
  d1 = rq(__fsub_rn(1.0f, rq(__fmul_rn(s, s), tv)), tv);
  d2 = rq(__fmul_rn(rq(-2.0f * s, tv), d1), tv);
  const float m2 = rq(__fmul_rn(rq(__fmul_rn(d2, px), tvd), px), tvd);
  const float m3 = rq(__fmul_rn(d1, pxx), tv && lq.txx);
  hxx = rq(rq(__fadd_rn(m2, m3), tvd && lq.txx), q.qxx);
  hx = rq(rq(__fmul_rn(d1, px), tvd), q.qd);
  ht = rq(rq(__fmul_rn(d1, pt), tvd), q.qd);
  h = rq(s, q.qv);
}

}  // namespace
