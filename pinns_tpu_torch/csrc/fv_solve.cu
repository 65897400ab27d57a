// K12, the finite-volume time stepper of the data generators, for Hopper
// (sm_90a).
//
// Replaces the JAX package's two lax.scan programs of the FV solvers
// (pinns_tpu/data/generators.py:141 euler_solve, scans :185-189; :205
// burgers_fv, scans :276-282): SSP-RK3 of a MUSCL-minmod finite-volume
// scheme in float32, a whole solve (the t_offset pre-steps, then n_snap - 1
// snapshot intervals of `steps` steps) in ONE launch.
//   burgers: a scalar state of n cells, the Godunov flux of f(u) = u^2 / 2,
//            outflow or periodic ghost cells, optional central viscosity nu;
//   euler:   the state (n, 3) [rho, rho u, E], the local Lax-Friedrichs flux,
//            outflow ghost cells.
// Snapshot k goes to out[k] in the plain version's layout: (n_snap, n) or
// (n_snap, n, 3), row 0 the state after the pre-steps.
//
// The scheme is the plain version's (data/generators.py: burgers_rhs,
// euler_rhs, rk3) op by op, each float32 operation spelled with an _rn
// intrinsic so that nvcc contracts nothing into an FMA that the plain
// version does not have; the minmod, the where-chains and the ghost rules
// are its own. ATen's CUDA true division by a host scalar (the plain
// version's / dx, / (dx * dx) and / 3.0) multiplies by the scalar's
// reciprocal, taken on the host in double and rounded to float; the wrapper
// passes those reciprocals (and checks ATen's rule once a device), and K12
// multiplies by them. So K12 equals the plain version on the card bit for
// bit.
//
// What bounds it on the H100: its chain of dependent steps. A solve is
// 3 x (steps x (n_snap - 1) + offset) stages, each of which needs every
// cell's neighbours from the stage before; the arithmetic (39 flops a cell
// a stage, Euler 104) and the snapshot bytes are far below the card's
// rates. Design: one CTA of up to 1,024 threads holds the state and the
// stage buffers in shared memory (Q, the stages S1 and S2, the limited
// slopes D: n floats each, Euler 3n; the face fluxes F: n + 1, Euler
// 3 (n + 1); above 48 KB by the opt-in), thread t owns cells t, t +
// blockDim, ...; a stage is slopes, __syncthreads, face fluxes,
// __syncthreads, update, __syncthreads. Stage 3 writes Q in place (a cell
// reads its own Q only). The largest n is what fits one CTA's shared memory
// (the wrapper refuses more, by name).

#include <cuda_runtime.h>

namespace {
namespace k12 {

constexpr int kMaxThreads = 1024;

struct Scalars {
  float dt, inv_dx, inv_dx2, nu, third, two3, gamma, gm1, eps;
};
constexpr int kScalars = 9;

__device__ __forceinline__ float sgn(float a) { return a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float minmod(float a, float b) {
  const float s = __fmul_rn(0.5f, __fadd_rn(sgn(a), sgn(b)));
  return __fmul_rn(s, fminf(fabsf(a), fabsf(b)));
}

// a / b as ATen divides a tensor by a host scalar b on the card: a times
// b's reciprocal
__device__ __forceinline__ float div_scalar(float a, float inv_b) { return __fmul_rn(a, inv_b); }

// the stage's combination of the step's start q, the stage input v and the
// right-hand side r at v: SSP-RK3's three stages
__device__ __forceinline__ float combine(int stage, float q, float v, float r,
                                         const Scalars& s) {
  if (stage == 1) return __fadd_rn(q, __fmul_rn(s.dt, r));
  const float w = __fadd_rn(v, __fmul_rn(s.dt, r));
  if (stage == 2) return __fadd_rn(__fmul_rn(0.75f, q), __fmul_rn(0.25f, w));
  return __fadd_rn(div_scalar(q, s.third), __fmul_rn(s.two3, w));
}

// ---------------------------------------------------------------- Burgers
__device__ __forceinline__ float half_sq(float u) { return __fmul_rn(__fmul_rn(0.5f, u), u); }

__device__ __forceinline__ float godunov(float ul, float ur) {
  const float shock = __fmul_rn(0.5f, __fadd_rn(ul, ur)) > 0.f ? half_sq(ul) : half_sq(ur);
  const float raref = ul > 0.f ? half_sq(ul) : (ur < 0.f ? half_sq(ur) : 0.f);
  return ul > ur ? shock : raref;
}

template <bool kPeriodic>
__device__ __forceinline__ int left_of(int i, int n) {
  return i > 0 ? i - 1 : (kPeriodic ? n - 1 : 0);
}

template <bool kPeriodic>
__device__ __forceinline__ int right_of(int i, int n) {
  return i < n - 1 ? i + 1 : (kPeriodic ? 0 : n - 1);
}

// one stage: out[i] = combine(Q[i], in[i], rhs(in)[i]); `out` may be Q
template <bool kPeriodic, bool kViscous>
__device__ void burgers_stage(int stage, const float* Q, const float* in, float* out, float* D,
                              float* F, int n, const Scalars& s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float c = in[i];
    D[i] = minmod(__fsub_rn(c, in[left_of<kPeriodic>(i, n)]),
                  __fsub_rn(in[right_of<kPeriodic>(i, n)], c));
  }
  __syncthreads();
  const int n_faces = kPeriodic ? n : n + 1;  // face j between cells j - 1 and j
  for (int j = threadIdx.x; j < n_faces; j += blockDim.x) {
    float ul, ur;
    if (kPeriodic) {
      const int m = j == 0 ? n - 1 : j - 1;
      ul = __fadd_rn(in[m], __fmul_rn(0.5f, D[m]));
      ur = __fsub_rn(in[j], __fmul_rn(0.5f, D[j]));
    } else {
      ul = j == 0 ? in[0] : __fadd_rn(in[j - 1], __fmul_rn(0.5f, D[j - 1]));
      ur = j == n ? in[n - 1] : __fsub_rn(in[j], __fmul_rn(0.5f, D[j]));
    }
    F[j] = godunov(ul, ur);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float f_right = F[kPeriodic ? (i + 1 == n ? 0 : i + 1) : i + 1];
    float r = div_scalar(-__fsub_rn(f_right, F[i]), s.inv_dx);
    if (kViscous) {
      const float c = in[i];
      float lap = __fadd_rn(__fsub_rn(in[right_of<kPeriodic>(i, n)], __fmul_rn(2.f, c)),
                            in[left_of<kPeriodic>(i, n)]);
      lap = div_scalar(lap, s.inv_dx2);
      r = __fadd_rn(r, __fmul_rn(s.nu, lap));
    }
    out[i] = combine(stage, Q[i], in[i], r, s);
  }
  __syncthreads();
}

template <bool kPeriodic, bool kViscous>
__global__ void __launch_bounds__(kMaxThreads)
    burgers_kernel(const float* __restrict__ u0, int n, Scalars s, int steps, int n_snap,
                   int offset, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* Q = sm;
  float* S1 = Q + n;
  float* S2 = S1 + n;
  float* D = S2 + n;
  float* F = D + n;  // n + 1
  for (int i = threadIdx.x; i < n; i += blockDim.x) Q[i] = u0[i];
  __syncthreads();
  for (int k = 0; k < n_snap; ++k) {
    const int m = k == 0 ? offset : steps;
    for (int t = 0; t < m; ++t) {
      burgers_stage<kPeriodic, kViscous>(1, Q, Q, S1, D, F, n, s);
      burgers_stage<kPeriodic, kViscous>(2, Q, S1, S2, D, F, n, s);
      burgers_stage<kPeriodic, kViscous>(3, Q, S2, Q, D, F, n, s);
    }
    float* row = out + static_cast<size_t>(k) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = Q[i];
  }
}

// ------------------------------------------------------------------ Euler
struct State {
  float rho, mom, e;
};

__device__ __forceinline__ void velocity_pressure(const State& q, const Scalars& s, float& u,
                                                  float& p) {
  u = __fdiv_rn(q.mom, q.rho);
  p = __fmul_rn(s.gm1, __fsub_rn(q.e, __fmul_rn(__fmul_rn(0.5f, q.mom), u)));
}

__device__ __forceinline__ float max_speed(const State& q, float u, float p, const Scalars& s) {
  const float c2 = fmaxf(__fdiv_rn(__fmul_rn(s.gamma, p), q.rho), s.eps);
  return __fadd_rn(fabsf(u), __fsqrt_rn(c2));
}

// the stage on SoA buffers: component c of cell i at [c * n + i], of face j
// at F[c * (n + 1) + j]; `out` may be Q
__device__ void euler_stage(int stage, const float* Q, const float* in, float* out, float* D,
                            float* F, int n, const Scalars& s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i > 0 ? i - 1 : 0, r = i < n - 1 ? i + 1 : n - 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* v = in + c * n;
      D[c * n + i] = minmod(__fsub_rn(v[i], v[l]), __fsub_rn(v[r], v[i]));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= n; j += blockDim.x) {
    float ql[3], qr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* v = in + c * n;
      const float* d = D + c * n;
      ql[c] = j == 0 ? v[0] : __fadd_rn(v[j - 1], __fmul_rn(0.5f, d[j - 1]));
      qr[c] = j == n ? v[n - 1] : __fsub_rn(v[j], __fmul_rn(0.5f, d[j]));
    }
    const State a{ql[0], ql[1], ql[2]}, b{qr[0], qr[1], qr[2]};
    float ua, pa, ub, pb;
    velocity_pressure(a, s, ua, pa);
    velocity_pressure(b, s, ub, pb);
    const float speed = fmaxf(max_speed(a, ua, pa, s), max_speed(b, ub, pb, s));
    const float half_speed = __fmul_rn(0.5f, speed);
    const float fa[3] = {a.mom, __fadd_rn(__fmul_rn(a.mom, ua), pa),
                         __fmul_rn(ua, __fadd_rn(a.e, pa))};
    const float fb[3] = {b.mom, __fadd_rn(__fmul_rn(b.mom, ub), pb),
                         __fmul_rn(ub, __fadd_rn(b.e, pb))};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      F[c * (n + 1) + j] = __fsub_rn(__fmul_rn(0.5f, __fadd_rn(fa[c], fb[c])),
                                     __fmul_rn(half_speed, __fsub_rn(qr[c], ql[c])));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* f = F + c * (n + 1);
      const float r = div_scalar(-__fsub_rn(f[i + 1], f[i]), s.inv_dx);
      out[c * n + i] = combine(stage, Q[c * n + i], in[c * n + i], r, s);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
    euler_kernel(const float* __restrict__ q0, int n, Scalars s, int steps, int n_snap,
                 float* __restrict__ out) {
  extern __shared__ float sm[];
  float* Q = sm;
  float* S1 = Q + 3 * n;
  float* S2 = S1 + 3 * n;
  float* D = S2 + 3 * n;
  float* F = D + 3 * n;  // 3 (n + 1)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) Q[c * n + i] = q0[3 * i + c];
  }
  __syncthreads();
  for (int k = 0; k < n_snap; ++k) {
    const int m = k == 0 ? 0 : steps;
    for (int t = 0; t < m; ++t) {
      euler_stage(1, Q, Q, S1, D, F, n, s);
      euler_stage(2, Q, S1, S2, D, F, n, s);
      euler_stage(3, Q, S2, Q, D, F, n, s);
    }
    float* row = out + static_cast<size_t>(k) * n * 3;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
      for (int c = 0; c < 3; ++c) row[3 * i + c] = Q[c * n + i];
    }
  }
}

size_t burgers_smem(int n) { return sizeof(float) * (5 * static_cast<size_t>(n) + 1); }
size_t euler_smem(int n) { return sizeof(float) * (15 * static_cast<size_t>(n) + 3); }

int threads_for(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

Scalars read_scalars(const float* v) {
  return Scalars{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kPeriodic, bool kViscous>
cudaError_t launch_burgers(const float* u0, int n, const Scalars& s, int steps, int n_snap,
                           int offset, float* out, cudaStream_t st) {
  const size_t bytes = burgers_smem(n);
  cudaError_t err = allow_smem(burgers_kernel<kPeriodic, kViscous>, bytes);
  if (err != cudaSuccess) return err;
  burgers_kernel<kPeriodic, kViscous>
      <<<1, threads_for(n), bytes, st>>>(u0, n, s, steps, n_snap, offset, out);
  return cudaGetLastError();
}

}  // namespace k12
}  // namespace

// The largest shared memory a block of `device` may opt into, in bytes.
extern "C" int pinns_fv_smem_optin(int device, int* bytes) {
  return static_cast<int>(
      cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// A Burgers solve: u0 (n,) float32 -> out (n_snap, n) float32 on `stream`.
// `scalars` (host, k12::kScalars floats): dt, 1/dx, 1/(dx*dx), nu, 1/3, 2/3,
// gamma, gamma - 1, the speed floor (the last three unused here), each
// reciprocal taken in double and rounded to float.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pinns_fv_burgers(const float* u0, int n, int periodic, int viscous,
                                const float* scalars, int steps, int n_snap,
                                int offset, float* out, int device, void* stream) {
  if (n < 3 || steps < 1 || n_snap < 1 || offset < 0 || scalars == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = k12::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const k12::Scalars s = k12::read_scalars(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (periodic) {
    err = viscous ? k12::launch_burgers<true, true>(u0, n, s, steps, n_snap, offset, out, st)
                  : k12::launch_burgers<true, false>(u0, n, s, steps, n_snap, offset, out, st);
  } else {
    err = viscous ? k12::launch_burgers<false, true>(u0, n, s, steps, n_snap, offset, out, st)
                  : k12::launch_burgers<false, false>(u0, n, s, steps, n_snap, offset, out, st);
  }
  return static_cast<int>(err);
}

// An Euler solve: q0 (n, 3) float32 -> out (n_snap, n, 3) float32 on
// `stream`; `scalars` as above (nu unused). Returns the CUDA error code.
extern "C" int pinns_fv_euler(const float* q0, int n, const float* scalars, int steps,
                              int n_snap, float* out, int device, void* stream) {
  if (n < 3 || steps < 1 || n_snap < 1 || scalars == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = k12::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const k12::Scalars s = k12::read_scalars(scalars);
  const size_t bytes = k12::euler_smem(n);
  err = k12::allow_smem(k12::euler_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k12::euler_kernel<<<1, k12::threads_for(n), bytes, static_cast<cudaStream_t>(stream)>>>(
      q0, n, s, steps, n_snap, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_fv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
