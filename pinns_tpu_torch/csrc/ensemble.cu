// K8s (c), the member reduction of a served ensemble, for Hopper (sm_90a).
//
// Replaces the XLA reduction that JAX runs over the stacked member
// predictions (pinns_tpu/parallel/ensemble.py:340-358 and
// pinns_tpu/serve.py:126-143: jnp.mean and jnp.std over axis 0, and the mean
// of the members' d/dx). It reads the (E, M) float32 stack of the members'
// fields (M = N points x C channels) and, when given, the (E, Md) stack of
// their x-derivatives, and writes
//   mean[i] = (v[0][i] + v[1][i] + ... + v[E-1][i]) / E
//   std[i]  = sqrt(((v[0][i] - mean[i])^2 + ... ) / E)      (population, ddof 0)
//   dx[i]   = |(d[0][i] + ... + d[E-1][i]) / E|
// The members summed in index order in float32, then divided by E; the
// deviations from that mean squared and summed in a second pass, as jnp.std
// does. The one-pass E[x^2] - E[x]^2 is not used: members agree to 1e-4 at
// most points, and it cancels. Every operation is spelled with a
// round-to-nearest intrinsic, so nothing is contracted into an FMA and the
// result is the plain float32 sum in member order.
//
// What bounds it on the H100: bytes. It reads E M + E Md floats once and
// writes 2 M + Md; at E 8 x 47,100 points x 6 fields with 3 dx fields that
// is about 16 MB, some 5 us at 3.35 TB/s. Design: one launch for the fields
// and the derivatives; a thread takes 4 consecutive (point, channel) entries
// with 16-byte loads and stores where its rows allow them (M % 4 == 0 and
// 16-byte aligned bases; else one entry, scalar), and holds their E members
// in registers, templated on a member bucket (E <= 8, 16, 32), so the stack
// is read once and the second pass runs on registers; above 32 members it
// loops over device memory twice. The launcher sets the device only when it
// is not the current one.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

template <int kW>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* r) { r[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* r) { *p = r[0]; }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* r) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* r) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};

// Entries i .. i + kW - 1 of a stack x (e, m): their mean into mu and, with
// `dev`, the population std into sd. kE > 0: the members (e <= kE) held in
// registers, one read; kE == 0: any e, the second pass reads again.
template <int kE, int kW>
__device__ __forceinline__ void member_reduce(const float* __restrict__ x, int e, long long m,
                                              long long i, bool dev, float (&mu)[kW],
                                              float (&sd)[kW]) {
  const float fe = static_cast<float>(e);
  float s[kW], q[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) s[w] = q[w] = 0.0f;
  if constexpr (kE > 0) {
    float r[kE][kW];
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      if (k < e) Vec<kW>::load(x + k * m + i, r[k]);
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (k < e) s[w] = __fadd_rn(s[w], r[k][w]);
      }
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) mu[w] = __fdiv_rn(s[w], fe);
    if (!dev) return;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (k < e) {
          const float t = __fsub_rn(r[k][w], mu[w]);
          q[w] = __fadd_rn(q[w], __fmul_rn(t, t));
        }
      }
    }
  } else {
    float r[kW];
    for (int k = 0; k < e; ++k) {
      Vec<kW>::load(x + k * m + i, r);
#pragma unroll
      for (int w = 0; w < kW; ++w) s[w] = __fadd_rn(s[w], r[w]);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) mu[w] = __fdiv_rn(s[w], fe);
    if (!dev) return;
    for (int k = 0; k < e; ++k) {
      Vec<kW>::load(x + k * m + i, r);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float t = __fsub_rn(r[w], mu[w]);
        q[w] = __fadd_rn(q[w], __fmul_rn(t, t));
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) sd[w] = __fsqrt_rn(__fdiv_rn(q[w], fe));
}

// Thread g's group of a stack: entries 4 g .. 4 g + 3 (kW 4) or g (kW 1).
template <int kE, int kW>
__device__ __forceinline__ void fields(const float* __restrict__ v, int e, long long m,
                                       long long g, float* __restrict__ mean,
                                       float* __restrict__ stdev) {
  const long long i = g * kW;
  if (i >= m) return;
  float mu[kW], sd[kW];
  member_reduce<kE, kW>(v, e, m, i, true, mu, sd);
  Vec<kW>::store(mean + i, mu);
  Vec<kW>::store(stdev + i, sd);
}

template <int kE, int kW>
__device__ __forceinline__ void derivatives(const float* __restrict__ d, int e, long long md,
                                            long long g, float* __restrict__ dxabs) {
  const long long i = g * kW;
  if (i >= md) return;
  float mu[kW], unused[kW];
  member_reduce<kE, kW>(d, e, md, i, false, mu, unused);
#pragma unroll
  for (int w = 0; w < kW; ++w) mu[w] = fabsf(mu[w]);
  Vec<kW>::store(dxabs + i, mu);
}

template <int kE>
__global__ void __launch_bounds__(kThreads)
member_stats_kernel(const float* __restrict__ v, const float* __restrict__ d, int e,
                    long long m, long long md, bool vec_v, bool vec_d,
                    float* __restrict__ mean, float* __restrict__ stdev,
                    float* __restrict__ dxabs) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec_v) {
    fields<kE, 4>(v, e, m, g, mean, stdev);
  } else {
    fields<kE, 1>(v, e, m, g, mean, stdev);
  }
  if (d == nullptr) return;
  if (vec_d) {
    derivatives<kE, 4>(d, e, md, g, dxabs);
  } else {
    derivatives<kE, 1>(d, e, md, g, dxabs);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

// The reduction on `stream`: v (e, m) float32 in device memory, d (e, md) or
// null; out (2 m + md floats): mean (m), std (m), then |mean dx| (md, none
// when d is null). Returns the CUDA error code of the launch (0 on success).
extern "C" int pinns_member_stats(const float* v, const float* d, int e, long long m,
                                  long long md, float* out, int device, void* stream) {
  if (e < 1 || m < 0 || md < 0 || (d == nullptr && md != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* mean = out;
  float* stdev = out + m;
  float* dxabs = out + 2 * m;
  const bool vec_v = m % 4 == 0 && aligned16(v) && aligned16(mean) && aligned16(stdev);
  const bool vec_d = md % 4 == 0 && aligned16(d) && aligned16(dxabs);
  const long long gv = vec_v ? m / 4 : m, gd = vec_d ? md / 4 : md;
  const long long work = gd > gv ? gd : gv;
  if (work == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((work + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 8) {
    member_stats_kernel<8><<<blocks, kThreads, 0, s>>>(v, d, e, m, md, vec_v, vec_d, mean,
                                                       stdev, dxabs);
  } else if (e <= 16) {
    member_stats_kernel<16><<<blocks, kThreads, 0, s>>>(v, d, e, m, md, vec_v, vec_d, mean,
                                                        stdev, dxabs);
  } else if (e <= 32) {
    member_stats_kernel<32><<<blocks, kThreads, 0, s>>>(v, d, e, m, md, vec_v, vec_d, mean,
                                                        stdev, dxabs);
  } else {
    member_stats_kernel<0><<<blocks, kThreads, 0, s>>>(v, d, e, m, md, vec_v, vec_d, mean,
                                                       stdev, dxabs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_ensemble_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
