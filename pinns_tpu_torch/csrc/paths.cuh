// The shock-path features of the first layer's input, for the input passes
// of K7a (csrc/taylor1.cu) and of K5's wide design (csrc/mlp_forward.cu),
// and the per-point chain rule of their backward.
//
// For K paths with coefficients c (K x (D + 1)) and sharpness a (K), at the
// normalized point (x_n, t_n) (pinns_tpu/models/mlp.py:242-275):
//   s_k = sum_j c_kj t_n^j        s'_k = sum_{j >= 1} j c_kj t_n^(j-1)
//   z_k = a_k (x_n - s_k)         phi_k = tanh z_k
//   phi_x = (1 - phi^2) a_k sx    phi_t = -(1 - phi^2) a_k st s'_k
// with sx = 2 / (ub0 - lb0), st = 2 / (ub1 - lb1) the input rescale. A
// point's first-layer input row is [x_n, t_n, phi_1 .. phi_K, 1, 0 ...] (the
// bias's indicator after the K features); K7a's tangent rows are
// [sx, 0, phi_x .., 0 ...] and [0, st, phi_t .., 0 ...].
//
// Backward: given the adjoints (gv, gx, gt) of a point's (phi, phi_x,
// phi_t) for path k (the path columns of gH_0 = G_0 W_0^T, one per stream;
// gx = gt = 0 for K5's value stream), with d1 = 1 - phi^2, d2 = -2 phi d1,
// zx = a sx, zt = -a st s':
//   gz      = gv d1 + d2 (gx zx + gt zt)
//   dL/da  += gz (x_n - s) + d1 (gx sx - gt st s')
//   dL/dc_j += -gz a t_n^j - [j >= 1] gt d1 a st j t_n^(j-1)
// The launchers sum these per 128-point block in double through a fixed
// tree and then over the blocks in block order (no atomics).
// ops/kernels/taylor1.py::taylor1_backward_reference holds this algorithm in
// plain PyTorch.

#pragma once

#include <cuda_runtime.h>

#include "layer_gemm.cuh"

namespace {

constexpr int kMaxPaths = 8;
constexpr int kMaxPathDegree = 7;

// The path parameters, device pointers into the flat params after the trunk:
// c (k x (degree + 1), row-major), then a (k). k = 0: no paths.
struct Paths {
  int k;
  int degree;
  const float* c;
  const float* a;
  __host__ __device__ int n_params() const { return k * (degree + 2); }
};

inline bool paths_ok(int k, int degree) {
  return k >= 0 && k <= kMaxPaths && degree >= 0 && degree <= kMaxPathDegree;
}

// One path at one point: s, s', phi and 1 - phi^2, in the JAX package's
// operation order (pw holds t_n^0 .. t_n^degree).
struct PathValue {
  float s, sp, phi, d1;
};

__device__ __forceinline__ PathValue path_value(const Paths& P, int k, float xn,
                                                const float* pw) {
  const float* c = P.c + k * (P.degree + 1);
  float s = 0.0f, sp = 0.0f;
  for (int j = 0; j <= P.degree; ++j) s = fmaf(pw[j], c[j], s);
  for (int j = 1; j <= P.degree; ++j) sp = fmaf(static_cast<float>(j) * pw[j - 1], c[j], sp);
  const float phi = tanhf(P.a[k] * (xn - s));
  return {s, sp, phi, 1.0f - phi * phi};
}

// The normalized coordinates of point p of x (n x 2); a padded point (p >=
// n) takes (0, 0), as the input passes pad.
__device__ __forceinline__ void normalized_point(const float* __restrict__ x, long long p, int n,
                                                 const Box& box, float* xn, float* tn) {
  float xv = 0.0f, tv = 0.0f;
  if (p < n) {
    xv = x[2 * p];
    tv = x[2 * p + 1];
  }
  *xn = 2.0f * (xv - box.lb0) / (box.ub0 - box.lb0) - 1.0f;
  *tn = 2.0f * (tv - box.lb1) / (box.ub1 - box.lb1) - 1.0f;
}

__device__ __forceinline__ void time_powers(float tn, int degree, float* pw) {
  pw[0] = 1.0f;
  for (int j = 1; j <= degree; ++j) pw[j] = pw[j - 1] * tn;
}

// Row `ld` floats of H_0 for the normalized point (xn, tn): the value row
// into hv and, unless null, the tangent rows into hx and ht (scale factors
// sx, st). Columns past the indicator are zero.
__device__ __forceinline__ void write_input_rows(const Paths& P, float xn, float tn, float sx,
                                                 float st, int ld, float* __restrict__ hv,
                                                 float* __restrict__ hx,
                                                 float* __restrict__ ht) {
  hv[0] = xn;
  hv[1] = tn;
  if (hx != nullptr) {
    hx[0] = sx;
    hx[1] = 0.0f;
    ht[0] = 0.0f;
    ht[1] = st;
  }
  float pw[kMaxPathDegree + 1];
  time_powers(tn, P.degree, pw);
  for (int k = 0; k < P.k; ++k) {
    const PathValue v = path_value(P, k, xn, pw);
    hv[2 + k] = v.phi;
    if (hx != nullptr) {
      const float a = P.a[k];
      hx[2 + k] = v.d1 * (a * sx);
      ht[2 + k] = v.d1 * (-(a * st) * v.sp);
    }
  }
  const int e = 2 + P.k;
  hv[e] = 1.0f;
  if (hx != nullptr) {
    hx[e] = 0.0f;
    ht[e] = 0.0f;
  }
  for (int c = e + 1; c < ld; ++c) {
    hv[c] = 0.0f;
    if (hx != nullptr) {
      hx[c] = 0.0f;
      ht[c] = 0.0f;
    }
  }
}

// The contribution of one point to parameter q of the path gradient (q <
// k (degree + 1): c's entries row-major, then a's), from the adjoints of
// its path features: gv[k], and, unless null, gx[k], gt[k].
__device__ __forceinline__ double path_grad_term(const Paths& P, int q, float xn, float sx,
                                                 float st, const float* pw,
                                                 const float* gv, const float* gx,
                                                 const float* gt) {
  const int per = P.degree + 1;
  const bool is_c = q < P.k * per;
  const int k = is_c ? q / per : q - P.k * per;
  const PathValue v = path_value(P, k, xn, pw);
  const float a = P.a[k];
  const float d2 = -2.0f * v.phi * v.d1;
  const float g = gv[k];
  const float hx = gx == nullptr ? 0.0f : gx[k];
  const float ht = gt == nullptr ? 0.0f : gt[k];
  const double zx = static_cast<double>(a) * sx;
  const double zt = -static_cast<double>(a) * st * v.sp;
  const double gz = static_cast<double>(g) * v.d1 + static_cast<double>(d2) * (hx * zx + ht * zt);
  if (!is_c) {
    return gz * (static_cast<double>(xn) - v.s) +
           static_cast<double>(v.d1) * (hx * static_cast<double>(sx) -
                                        ht * static_cast<double>(st) * v.sp);
  }
  const int j = q - k * per;
  double t = -gz * a * pw[j];
  if (j >= 1) t -= static_cast<double>(ht) * v.d1 * a * st * j * pw[j - 1];
  return t;
}

// The block's share of the path gradient: thread i takes point
// blockIdx.x * blockDim.x + i (blockDim.x a power of two, points past n add
// zero); for each parameter q the block's sum, in double through a fixed
// tree, goes to psums[blockIdx.x * P.n_params() + q]. gv (and, unless null,
// gx, gt) point at the path columns of the point's adjoint rows, ld_g floats
// apart. Every thread of the block calls it.
__device__ __forceinline__ void path_grad_block(const float* __restrict__ x, int n,
                                                const Box& box, const Paths& P,
                                                const float* gv, const float* gx,
                                                const float* gt, int ld_g,
                                                double* __restrict__ psums) {
  extern __shared__ double part[];
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float xn, tn;
  normalized_point(x, p, n, box, &xn, &tn);
  float pw[kMaxPathDegree + 1];
  time_powers(tn, P.degree, pw);
  const float sx = 2.0f / (box.ub0 - box.lb0), st = 2.0f / (box.ub1 - box.lb1);
  const long long at = p * ld_g;
  for (int q = 0; q < P.n_params(); ++q) {
    part[threadIdx.x] = p < n ? path_grad_term(P, q, xn, sx, st, pw, gv + at,
                                               gx == nullptr ? nullptr : gx + at,
                                               gt == nullptr ? nullptr : gt + at)
                              : 0.0;
    __syncthreads();
    for (int w = blockDim.x / 2; w >= 1; w /= 2) {
      if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) psums[static_cast<long long>(blockIdx.x) * P.n_params() + q] = part[0];
    __syncthreads();
  }
}

// Parameter q of the path gradient: the blocks' partials summed in double
// in block order.
__device__ __forceinline__ float path_grad_sum(const double* __restrict__ psums, int blocks,
                                               int n_path_params, int q) {
  double t = 0.0;
  for (int b = 0; b < blocks; ++b) t += psums[static_cast<long long>(b) * n_path_params + q];
  return static_cast<float>(t);
}

}  // namespace
