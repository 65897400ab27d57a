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
// One thread a (point, channel): the members summed in index order in
// float32, then divided by E; the deviations from that mean squared and
// summed in a second pass, as jnp.std does. The one-pass E[x^2] - E[x]^2
// is not used: members agree to 1e-4 at most points, and it cancels. Every
// operation is spelled with a round-to-nearest intrinsic, so nothing is
// contracted into an FMA and the result is the plain float32 sum in member
// order.
//
// What bounds it on the H100: bytes. It reads E M + E Md floats once and
// writes 2 M + Md; at E 8 x 47,100 points x 3 fields with dx that is about
// 9 MB, some 3 us at 3.35 TB/s. A served call is far smaller than a launch's
// overhead makes worth tuning: the kernel is the simple one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
member_stats_kernel(const float* __restrict__ v, const float* __restrict__ d, int e,
                    long long m, long long md, float* __restrict__ mean,
                    float* __restrict__ stdev, float* __restrict__ dxabs) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float fe = static_cast<float>(e);
  if (i < m) {
    float s = 0.0f;
    for (int k = 0; k < e; ++k) s = __fadd_rn(s, v[k * m + i]);
    const float mu = __fdiv_rn(s, fe);
    float q = 0.0f;
    for (int k = 0; k < e; ++k) {
      const float t = __fsub_rn(v[k * m + i], mu);
      q = __fadd_rn(q, __fmul_rn(t, t));
    }
    mean[i] = mu;
    stdev[i] = __fsqrt_rn(__fdiv_rn(q, fe));
  }
  if (d != nullptr && i < md) {
    float s = 0.0f;
    for (int k = 0; k < e; ++k) s = __fadd_rn(s, d[k * md + i]);
    dxabs[i] = fabsf(__fdiv_rn(s, fe));
  }
}

}  // namespace

// The reduction on `stream`: v (e, m) float32 in device memory, d (e, md) or
// null; mean and std (m), dx (md, ignored when d is null). Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pinns_member_stats(const float* v, const float* d, int e, long long m,
                                  long long md, float* mean, float* stdev, float* dxabs,
                                  int device, void* stream) {
  if (e < 1 || m < 0 || md < 0 || (d != nullptr && dxabs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = d != nullptr && md > m ? md : m;
  if (work == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((work + kThreads - 1) / kThreads);
  member_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, d, e, m, md, mean, stdev, dxabs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_ensemble_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
