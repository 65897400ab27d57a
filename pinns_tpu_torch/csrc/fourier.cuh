// The first layer's input rows of a point, shared by the input passes of
// K1 (csrc/taylor2.cu), K2 (csrc/taylor2_backward.cu), K7a (csrc/taylor1.cu)
// and K5's wide design (csrc/mlp_forward.cu): the normalized coordinates,
// the Fourier features and the shock-path features, with their streams
// w.r.t. the raw inputs (pinns_tpu/models/mlp.py:279-340).
//
// At the normalized point (x_n, t_n), with sx = 2 / (ub0 - lb0) and st = 2 /
// (ub1 - lb1) the input rescale:
//   Fourier feature f (F of them, b = 2 pi B^T, B the spec's (F, 2) rows):
//     z_f = x_n bx_f + t_n bt_f,   zx_f = sx bx_f,   zt_f = st bt_f
//     value   sin z, cos z          x stream   cos z zx, -sin z zx
//     t stream cos z zt, -sin z zt  xx stream  -sin z zx zx, -cos z zx zx
//   shock path k (K of them, coefficients c (K x (D + 1)), sharpness a (K)):
//     s_k = sum_j c_kj t_n^j        s'_k = sum_{j >= 1} j c_kj t_n^(j-1)
//     z_k = a_k (x_n - s_k)         phi_k = tanh z_k,  d1 = 1 - phi^2
//     phi_x = d1 a_k sx   phi_t = -d1 a_k st s'_k   phi_xx = -2 phi d1 (a_k sx)^2
// A point's row is [x_n, t_n, sin z_1..F, cos z_1..F, phi_1..K] (2 + 2F + K
// columns), then, where the caller's row is wider, the bias's indicator (1
// on the value row, 0 on the derivative rows) and zeros. The tangent rows
// start (sx, 0) and (0, st); the xx row starts (0, 0).
//
// sinf / cosf, never the __sinf / __cosf intrinsics (and the build passes no
// --use_fast_math): with sigma = 3 and |x_n|, |t_n| <= 1, |z| reaches about
// 60 rad, where the intrinsics lose digits. B is passed by value (at most
// kMaxFourier rows), so a captured CUDA graph holds it.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFourier = 64;
constexpr int kMaxPaths = 8;
constexpr int kMaxPathDegree = 7;

// The Fourier features' frequencies: bx = 2 pi B[:, 0], bt = 2 pi B[:, 1],
// each rounded to float32 as the JAX package rounds them. f = 0: none.
struct Fourier {
  int f;
  float bx[kMaxFourier];
  float bt[kMaxFourier];
};

inline bool fourier_ok(int f) { return f >= 0 && f <= kMaxFourier; }

// A Fourier from its launcher's host arguments: f, and b (host memory, 2 f
// floats: bx then bt; null when f = 0).
inline Fourier make_fourier(int f, const float* b) {
  Fourier F{};
  F.f = f;
  for (int i = 0; i < f && i < kMaxFourier; ++i) {
    F.bx[i] = b[i];
    F.bt[i] = b[f + i];
  }
  return F;
}

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

// The width of the first layer's input.
__host__ __device__ __forceinline__ int embed_width(const Fourier& F, const Paths& P) {
  return 2 + 2 * F.f + P.k;
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

__device__ __forceinline__ void time_powers(float tn, int degree, float* pw) {
  pw[0] = 1.0f;
  for (int j = 1; j <= degree; ++j) pw[j] = pw[j - 1] * tn;
}

// The input rows of the normalized point (xn, tn): column c of the value row
// at hv[c cs] and, unless null, of the x, t and xx rows at hx, ht, hxx.
// Columns from embed_width to ld - 1 take the indicator and zeros (none
// when ld equals the width).
__device__ __forceinline__ void write_input_rows(const Fourier& F, const Paths& P, float xn,
                                                 float tn, float sx, float st, int ld, int cs,
                                                 float* __restrict__ hv, float* __restrict__ hx,
                                                 float* __restrict__ ht,
                                                 float* __restrict__ hxx) {
  const auto put = [&](int c, float v, float vx, float vt, float vxx) {
    hv[c * cs] = v;
    if (hx != nullptr) {
      hx[c * cs] = vx;
      ht[c * cs] = vt;
    }
    if (hxx != nullptr) hxx[c * cs] = vxx;
  };
  put(0, xn, sx, 0.0f, 0.0f);
  put(1, tn, 0.0f, st, 0.0f);
  for (int f = 0; f < F.f; ++f) {
    const float z = fmaf(tn, F.bt[f], xn * F.bx[f]);
    const float sn = sinf(z), cs_ = cosf(z);
    const float zx = sx * F.bx[f], zt = st * F.bt[f];
    put(2 + f, sn, cs_ * zx, cs_ * zt, -sn * zx * zx);
    put(2 + F.f + f, cs_, -sn * zx, -sn * zt, -cs_ * zx * zx);
  }
  float pw[kMaxPathDegree + 1];
  time_powers(tn, P.degree, pw);
  const int p0 = 2 + 2 * F.f;
  for (int k = 0; k < P.k; ++k) {
    const PathValue v = path_value(P, k, xn, pw);
    const float zx = P.a[k] * sx;
    put(p0 + k, v.phi, v.d1 * zx, v.d1 * (-(P.a[k] * st) * v.sp),
        (-2.0f * v.phi * v.d1) * (zx * zx));
  }
  const int e = p0 + P.k;
  for (int c = e; c < ld; ++c) put(c, c == e ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace
