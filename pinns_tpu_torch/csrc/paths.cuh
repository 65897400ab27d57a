// The backward of the shock-path features of the first layer's input (the
// rows themselves: csrc/fourier.cuh), for K2 (csrc/taylor2_backward.cu),
// K7a (csrc/taylor1.cu) and K5's wide design (csrc/mlp_forward.cu): the
// per-point chain rule and its fixed-order sums.
//
// Given the adjoints (gv, gx, gt, gxx) of a point's (phi, phi_x, phi_t,
// phi_xx) for path k (the path columns of gH_0 = G_0 W_0^T, one per stream,
// at column 2 + 2F of the row; gx = gt = gxx = 0 for K5's value stream, gxx
// = 0 for K7a), with d1 = 1 - phi^2, d2 = -2 phi d1, zx = a sx, zt = -a st s'
// (csrc/fourier.cuh has the forward; pinns_tpu/models/mlp.py:242-277):
//   gz      = gv d1 + d2 (gx zx + gt zt) + gxx d1 (6 phi^2 - 2) zx^2
//   dL/da  += gz (x_n - s) + d1 (gx sx - gt st s') + gxx 2 d2 a sx^2
//   dL/dc_j += -gz a t_n^j - [j >= 1] gt d1 a st j t_n^(j-1)
// The terms are taken in double. The launchers sum them per 128-point block
// in double through a fixed tree and then over the blocks in block order (no
// atomics), so two calls agree bit for bit.
// models/mlp.py::path_backward_reference holds this algorithm in plain
// PyTorch.

#pragma once

#include <cuda_runtime.h>

#include "fourier.cuh"
#include "layer_gemm.cuh"

namespace {

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

// The contribution of one point to parameter q of the path gradient (q <
// k (degree + 1): c's entries row-major, then a's), from the adjoints of
// its path features: gv[k], and, unless null, gx[k], gt[k] and gxx[k].
__device__ __forceinline__ double path_grad_term(const Paths& P, int q, float xn, float sx,
                                                 float st, const float* pw,
                                                 const float* gv, const float* gx,
                                                 const float* gt, const float* gxx) {
  const int per = P.degree + 1;
  const bool is_c = q < P.k * per;
  const int k = is_c ? q / per : q - P.k * per;
  const PathValue v = path_value(P, k, xn, pw);
  const float a = P.a[k];
  const float d2 = -2.0f * v.phi * v.d1;
  const float g = gv[k];
  const float hx = gx == nullptr ? 0.0f : gx[k];
  const float ht = gt == nullptr ? 0.0f : gt[k];
  const float hxx = gxx == nullptr ? 0.0f : gxx[k];
  const double zx = static_cast<double>(a) * sx;
  const double zt = -static_cast<double>(a) * st * v.sp;
  double gz = static_cast<double>(g) * v.d1 + static_cast<double>(d2) * (hx * zx + ht * zt);
  if (hxx != 0.0f) {
    const double phi = v.phi;
    gz += static_cast<double>(hxx) * v.d1 * (6.0 * phi * phi - 2.0) * zx * zx;
  }
  if (!is_c) {
    double t = gz * (static_cast<double>(xn) - v.s) +
               static_cast<double>(v.d1) * (hx * static_cast<double>(sx) -
                                            ht * static_cast<double>(st) * v.sp);
    if (hxx != 0.0f) t += 2.0 * hxx * static_cast<double>(d2) * a * sx * static_cast<double>(sx);
    return t;
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
// gx, gt, gxx) point at the path columns of the point's adjoint rows, ld_g
// floats apart. Every thread of the block calls it.
__device__ __forceinline__ void path_grad_block(const float* __restrict__ x, int n,
                                                const Box& box, const Paths& P,
                                                const float* gv, const float* gx,
                                                const float* gt, const float* gxx, int ld_g,
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
                                               gt == nullptr ? nullptr : gt + at,
                                               gxx == nullptr ? nullptr : gxx + at)
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
