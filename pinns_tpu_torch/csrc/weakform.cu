// K7b: the weak-form (finite-volume) flux quadrature, for Hopper (sm_90a).
//
// Replaces the XLA programs of pinns_tpu/ops/weakform.py::
// burgers_flux_residual (:87) and euler_flux_residuals (:182) around the net
// (the JAX package had no Pallas kernel for them): for N control volumes
// centred at the collocation points, clipped to the domain, the Q-node
// Gauss-Legendre points of the four edges, and from the net's values (and
// x-derivatives when viscous) at those points the cell-mean residual
//   r = (hxe sum_q w_q (U_top - U_bot) + hte sum_q w_q (F_right - F_left))
//       / (4 hxe hte)
// with Burgers' U = u, F = lambda1 u^2 / 2 - lambda2 u_x, or the Euler
// system's U = (rho, rho u, E), F = (rho u, rho u^2 + p, u (E + p)) - visc
// dU/dx, p = (gamma - 1)(E - rho u^2 / 2). ops/weakform.py holds the plain
// PyTorch versions (edge_points_reference, burgers_quadrature_reference,
// euler_quadrature_reference).
//
// Three launches a training step (the net between them is K7a or K5):
//   edge_points   one thread per (cell, edge, node): the points (N 4Q, 2) in
//                 JAX's row order cell 4Q + edge Q + q, edges [bottom t1,
//                 top t2, left x1, right x2], and the clipped half-widths
//                 hxe, hte (N);
//   flux_forward  one thread per cell, templated on the equation (C = 1
//                 Burgers, C = 3 Euler) and on the viscous term: r (N, C);
//   flux_backward one thread per cell: from g_r (N, C) the cotangents of the
//                 net's values and x-derivatives (N 4Q, C), and per-block
//                 partial sums, in double, of the coefficients' gradient
//                 (lambda1, lambda2 for Burgers; visc for Euler); a second
//                 launch of one thread per coefficient sums the partials in
//                 block order. No atomics: two calls agree bit for bit.
// The forward passes spell every float32 operation out with the _rn
// intrinsics, in the plain version's order (the quadrature sums run over q
// in order), so that nvcc's FMA contraction cannot move the edge points or r
// away from the plain version on the card. The coefficients come as a device
// vector (lambda1, lambda2) or (gamma - 1, visc), so a trainable viscosity
// never leaves the card.
//
// What bounds it on the H100: bytes and launches. At the presets' N 1,000
// cells and Q 4 the forward reads the 16,000 edge rows' values and
// derivatives (128 KB at C 1, 384 KB at C 3) and the backward writes as
// much; at 3.35 TB/s that is well under a microsecond, so each call waits on
// its launch. The design keeps it to one pass per stage with no scratch
// beyond the partials; fusing the edge points into K7a's first layer and the
// quadrature into its head is later speed work. Every kernel is in
// namespace k7b, so a profile tells them apart.

#include <cuda_runtime.h>

namespace {
namespace k7b {

constexpr int kMaxQuad = 8;
constexpr int kBlock = 256;
constexpr int kCoeffs = 2;

struct Quad {
  float v[kMaxQuad];
};

__global__ void edge_points_kernel(const float* __restrict__ centers, int n, int q, float lbx,
                                   float lbt, float ubx, float ubt, float hx, float ht, Quad g,
                                   float* __restrict__ pts, float* __restrict__ hxe_out,
                                   float* __restrict__ hte_out) {
  const int per = 4 * q;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n) * per) return;
  const int cell = static_cast<int>(i / per);
  const int rem = static_cast<int>(i - static_cast<long long>(cell) * per);
  const int edge = rem / q, k = rem - edge * q;
  const float cx = centers[2 * cell], ct = centers[2 * cell + 1];
  const float x1 = fmaxf(__fsub_rn(cx, hx), lbx);
  const float x2 = fminf(__fadd_rn(cx, hx), ubx);
  const float t1 = fmaxf(__fsub_rn(ct, ht), lbt);
  const float t2 = fminf(__fadd_rn(ct, ht), ubt);
  const float hxe = __fmul_rn(0.5f, __fsub_rn(x2, x1));
  const float hte = __fmul_rn(0.5f, __fsub_rn(t2, t1));
  float px, pt;
  if (edge < 2) {
    px = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(x1, x2)), __fmul_rn(hxe, g.v[k]));
    pt = edge == 0 ? t1 : t2;
  } else {
    px = edge == 2 ? x1 : x2;
    pt = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(t1, t2)), __fmul_rn(hte, g.v[k]));
  }
  pts[2 * i] = px;
  pts[2 * i + 1] = pt;
  if (rem == 0) {
    hxe_out[cell] = hxe;
    hte_out[cell] = hte;
  }
}

// The Euler conserved variables and fluxes at one edge row (the plain
// version's euler_conserved_flux, viscous term included).
template <bool kViscous>
__device__ __forceinline__ void euler_row(const float* __restrict__ y,
                                          const float* __restrict__ yx, long long row,
                                          float gm1, float visc, float cons[3], float flux[3]) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  const float ru = __fmul_rn(rho, u);
  const float p = __fmul_rn(gm1, __fsub_rn(e, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, rho), u), u)));
  cons[0] = rho;
  cons[1] = ru;
  cons[2] = e;
  flux[0] = ru;
  flux[1] = __fadd_rn(__fmul_rn(ru, u), p);
  flux[2] = __fmul_rn(u, __fadd_rn(e, p));
  if constexpr (kViscous) {
    const float rho_x = yx[3 * row], u_x = yx[3 * row + 1], e_x = yx[3 * row + 2];
    const float mom_x = __fadd_rn(__fmul_rn(rho_x, u), __fmul_rn(rho, u_x));
    flux[0] = __fsub_rn(flux[0], __fmul_rn(visc, rho_x));
    flux[1] = __fsub_rn(flux[1], __fmul_rn(visc, mom_x));
    flux[2] = __fsub_rn(flux[2], __fmul_rn(visc, e_x));
  }
}

// The Burgers flux at one side-edge row.
template <bool kViscous>
__device__ __forceinline__ float burgers_flux(const float* __restrict__ y,
                                              const float* __restrict__ yx, long long row,
                                              float half_lam1, float lam2) {
  const float u = y[row];
  float f = __fmul_rn(__fmul_rn(half_lam1, u), u);
  if constexpr (kViscous) f = __fsub_rn(f, __fmul_rn(lam2, yx[row]));
  return f;
}

template <int C, bool kViscous>
__global__ void flux_forward_kernel(const float* __restrict__ y, const float* __restrict__ yx,
                                    const float* __restrict__ hxe, const float* __restrict__ hte,
                                    const float* __restrict__ coeffs, int n, int q, Quad w,
                                    float* __restrict__ r) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const long long base = static_cast<long long>(cell) * 4 * q;
  const float c0 = coeffs[0], c1 = coeffs[1];
  float s1[C], s2[C];
  for (int k = 0; k < q; ++k) {
    const long long bot = base + k, top = base + q + k, lef = base + 2 * q + k,
                    rig = base + 3 * q + k;
    float d1[C], d2[C];
    if constexpr (C == 1) {
      const float half_lam1 = __fmul_rn(0.5f, c0);
      d1[0] = __fsub_rn(y[top], y[bot]);
      d2[0] = __fsub_rn(burgers_flux<kViscous>(y, yx, rig, half_lam1, c1),
                        burgers_flux<kViscous>(y, yx, lef, half_lam1, c1));
    } else {
      float cb[3], ct[3], cl[3], cr[3], fb[3], ft[3], fl[3], fr[3];
      euler_row<false>(y, yx, bot, c0, c1, cb, fb);
      euler_row<false>(y, yx, top, c0, c1, ct, ft);
      euler_row<kViscous>(y, yx, lef, c0, c1, cl, fl);
      euler_row<kViscous>(y, yx, rig, c0, c1, cr, fr);
      for (int c = 0; c < C; ++c) {
        d1[c] = __fsub_rn(ct[c], cb[c]);
        d2[c] = __fsub_rn(fr[c], fl[c]);
      }
    }
    for (int c = 0; c < C; ++c) {
      const float a = __fmul_rn(d1[c], w.v[k]), b = __fmul_rn(d2[c], w.v[k]);
      s1[c] = k == 0 ? a : __fadd_rn(s1[c], a);
      s2[c] = k == 0 ? b : __fadd_rn(s2[c], b);
    }
  }
  const float hx = hxe[cell], ht = hte[cell];
  const float measure = __fmul_rn(__fmul_rn(4.0f, hx), ht);
  for (int c = 0; c < C; ++c) {
    r[static_cast<long long>(cell) * C + c] =
        __fdiv_rn(__fadd_rn(__fmul_rn(hx, s1[c]), __fmul_rn(ht, s2[c])), measure);
  }
}

// The block's sums of the threads' (a, b) in double, by a fixed tree, into
// partials[2 block], partials[2 block + 1].
__device__ __forceinline__ void block_sum(double a, double b, double* __restrict__ partials) {
  __shared__ double sa[kBlock], sb[kBlock];
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
      sa[threadIdx.x] += sa[threadIdx.x + stride];
      sb[threadIdx.x] += sb[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[kCoeffs * blockIdx.x] = sa[0];
    partials[kCoeffs * blockIdx.x + 1] = sb[0];
  }
}

// Burgers: g_u, g_ux at the cell's 4Q rows; (dlambda1, dlambda2).
template <bool kViscous>
__global__ void burgers_backward_kernel(const float* __restrict__ gr,
                                        const float* __restrict__ y,
                                        const float* __restrict__ yx,
                                        const float* __restrict__ hxe,
                                        const float* __restrict__ hte,
                                        const float* __restrict__ coeffs, int n, int q, Quad w,
                                        float* __restrict__ gy, float* __restrict__ gyx,
                                        double* __restrict__ partials) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  double d_lam1 = 0.0, d_lam2 = 0.0;
  if (cell < n) {
    const long long base = static_cast<long long>(cell) * 4 * q;
    const float lam1 = coeffs[0], lam2 = coeffs[1];
    const float hx = hxe[cell], ht = hte[cell];
    const float g_over = gr[cell] / (4.0f * hx * ht);
    const float g1 = g_over * hx, g2 = g_over * ht;  // d r / d(sum_top-bot), (sum_right-left)
    for (int k = 0; k < q; ++k) {
      const long long bot = base + k, top = base + q + k, lef = base + 2 * q + k,
                      rig = base + 3 * q + k;
      const float gc = g1 * w.v[k], gf = g2 * w.v[k];  // top: +gc, right: +gf
      const float ul = y[lef], ur = y[rig];
      gy[bot] = -gc;
      gy[top] = gc;
      gy[lef] = -gf * lam1 * ul;
      gy[rig] = gf * lam1 * ur;
      d_lam1 += 0.5 * static_cast<double>(gf) *
                (static_cast<double>(ur) * ur - static_cast<double>(ul) * ul);
      if constexpr (kViscous) {
        gyx[bot] = 0.0f;
        gyx[top] = 0.0f;
        gyx[lef] = gf * lam2;
        gyx[rig] = -gf * lam2;
        d_lam2 -= static_cast<double>(gf) * (static_cast<double>(yx[rig]) - yx[lef]);
      }
    }
  }
  block_sum(d_lam1, d_lam2, partials);
}

// The cotangents of (rho, u, E) (and of their x-derivatives) at one edge
// row from those of its conserved variables (gcons) or fluxes (gflux);
// returns the row's part of d/dvisc.
template <bool kViscous, bool kSide>
__device__ __forceinline__ double euler_row_backward(const float* __restrict__ y,
                                                     const float* __restrict__ yx,
                                                     long long row, float gm1, float visc,
                                                     const float g[3], float* __restrict__ gy,
                                                     float* __restrict__ gyx) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  if constexpr (!kSide) {  // U = (rho, rho u, E)
    gy[3 * row] = g[0] + g[1] * u;
    gy[3 * row + 1] = g[1] * rho;
    gy[3 * row + 2] = g[2];
    if constexpr (kViscous) gyx[3 * row] = gyx[3 * row + 1] = gyx[3 * row + 2] = 0.0f;
    return 0.0;
  }
  // F = (rho u, rho u^2 + p, u (E + p)), p = gm1 (E - rho u^2 / 2)
  const float p = gm1 * (e - 0.5f * rho * u * u);
  const float dp_drho = -0.5f * gm1 * u * u, dp_du = -gm1 * rho * u;
  float g_rho = g[0] * u + g[1] * (u * u + dp_drho) + g[2] * u * dp_drho;
  float g_u = g[0] * rho + g[1] * (2.0f * rho * u + dp_du) + g[2] * ((e + p) + u * dp_du);
  const float g_e = g[1] * gm1 + g[2] * u * (1.0f + gm1);
  double d_visc = 0.0;
  if constexpr (kViscous) {  // F -= visc (rho_x, rho_x u + rho u_x, E_x)
    const float rho_x = yx[3 * row], u_x = yx[3 * row + 1], e_x = yx[3 * row + 2];
    g_rho -= visc * g[1] * u_x;
    g_u -= visc * g[1] * rho_x;
    gyx[3 * row] = -visc * (g[0] + g[1] * u);
    gyx[3 * row + 1] = -visc * g[1] * rho;
    gyx[3 * row + 2] = -visc * g[2];
    d_visc = -(static_cast<double>(g[0]) * rho_x +
               static_cast<double>(g[1]) *
                   (static_cast<double>(rho_x) * u + static_cast<double>(rho) * u_x) +
               static_cast<double>(g[2]) * e_x);
  }
  gy[3 * row] = g_rho;
  gy[3 * row + 1] = g_u;
  gy[3 * row + 2] = g_e;
  return d_visc;
}

// Euler: g_y, g_yx at the cell's 4Q rows; (0, dvisc).
template <bool kViscous>
__global__ void euler_backward_kernel(const float* __restrict__ gr, const float* __restrict__ y,
                                      const float* __restrict__ yx,
                                      const float* __restrict__ hxe,
                                      const float* __restrict__ hte,
                                      const float* __restrict__ coeffs, int n, int q, Quad w,
                                      float* __restrict__ gy, float* __restrict__ gyx,
                                      double* __restrict__ partials) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  double d_visc = 0.0;
  if (cell < n) {
    const long long base = static_cast<long long>(cell) * 4 * q;
    const float gm1 = coeffs[0], visc = coeffs[1];
    const float hx = hxe[cell], ht = hte[cell];
    const float inv = 1.0f / (4.0f * hx * ht);
    float g1[3], g2[3];
    for (int c = 0; c < 3; ++c) {
      const float g_over = gr[3 * static_cast<long long>(cell) + c] * inv;
      g1[c] = g_over * hx;
      g2[c] = g_over * ht;
    }
    for (int k = 0; k < q; ++k) {
      float pos_c[3], neg_c[3], pos_f[3], neg_f[3];
      for (int c = 0; c < 3; ++c) {
        pos_c[c] = g1[c] * w.v[k];
        neg_c[c] = -pos_c[c];
        pos_f[c] = g2[c] * w.v[k];
        neg_f[c] = -pos_f[c];
      }
      euler_row_backward<kViscous, false>(y, yx, base + k, gm1, visc, neg_c, gy, gyx);
      euler_row_backward<kViscous, false>(y, yx, base + q + k, gm1, visc, pos_c, gy, gyx);
      d_visc += euler_row_backward<kViscous, true>(y, yx, base + 2 * q + k, gm1, visc, neg_f,
                                                   gy, gyx);
      d_visc += euler_row_backward<kViscous, true>(y, yx, base + 3 * q + k, gm1, visc, pos_f,
                                                   gy, gyx);
    }
  }
  block_sum(0.0, d_visc, partials);
}

// g_coeffs[j] = sum over blocks, in block order, of partials[2 b + j].
__global__ void sum_partials_kernel(const double* __restrict__ partials, int blocks,
                                    float* __restrict__ g_coeffs) {
  const int j = threadIdx.x;
  if (j >= kCoeffs) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partials[kCoeffs * b + j];
  g_coeffs[j] = static_cast<float>(s);
}

Quad to_quad(const float* host, int q) {
  Quad out{};
  for (int k = 0; k < q; ++k) out.v[k] = host[k];
  return out;
}

int blocks_for(long long threads) { return static_cast<int>((threads + kBlock - 1) / kBlock); }

}  // namespace k7b
}  // namespace

#define K7B_CHECK(expr)                                   \
  do {                                                    \
    const cudaError_t e_ = (expr);                        \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

// The edge points of n cells (n >= 1, 1 <= q <= 8): pts (n 4q, 2), hxe and
// hte (n); `nodes` is a host array of the q Gauss-Legendre nodes.
extern "C" int pinns_weakform_edge_points(const float* centers, int n, int q, float lbx,
                                          float lbt, float ubx, float ubt, float hx, float ht,
                                          const float* nodes, float* pts, float* hxe, float* hte,
                                          int device, void* stream) {
  if (n < 1 || q < 1 || q > k7b::kMaxQuad) return static_cast<int>(cudaErrorInvalidValue);
  K7B_CHECK(cudaSetDevice(device));
  const long long threads = static_cast<long long>(n) * 4 * q;
  k7b::edge_points_kernel<<<k7b::blocks_for(threads), k7b::kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      centers, n, q, lbx, lbt, ubx, ubt, hx, ht, k7b::to_quad(nodes, q), pts, hxe, hte);
  return static_cast<int>(cudaGetLastError());
}

// r (n, C) from the net at the edge rows: kind 0 Burgers (C 1, coeffs
// (lambda1, lambda2)), 1 Euler (C 3, coeffs (gamma - 1, visc)); yx is read
// only when `viscous`; `weights` a host array of the q quadrature weights.
extern "C" int pinns_weakform_flux_forward(int kind, int viscous, const float* y, const float* yx,
                                           const float* hxe, const float* hte,
                                           const float* coeffs, int n, int q,
                                           const float* weights, float* r, int device,
                                           void* stream) {
  if (n < 1 || q < 1 || q > k7b::kMaxQuad || kind < 0 || kind > 1 || (viscous && !yx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K7B_CHECK(cudaSetDevice(device));
  const k7b::Quad w = k7b::to_quad(weights, q);
  const int blocks = k7b::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (viscous) {
      k7b::flux_forward_kernel<1, true><<<blocks, k7b::kBlock, 0, s>>>(y, yx, hxe, hte, coeffs,
                                                                      n, q, w, r);
    } else {
      k7b::flux_forward_kernel<1, false><<<blocks, k7b::kBlock, 0, s>>>(y, yx, hxe, hte, coeffs,
                                                                       n, q, w, r);
    }
  } else if (viscous) {
    k7b::flux_forward_kernel<3, true><<<blocks, k7b::kBlock, 0, s>>>(y, yx, hxe, hte, coeffs, n,
                                                                    q, w, r);
  } else {
    k7b::flux_forward_kernel<3, false><<<blocks, k7b::kBlock, 0, s>>>(y, yx, hxe, hte, coeffs,
                                                                     n, q, w, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// From g_r (n, C): g_y and (when viscous) g_yx (n 4q, C), and g_coeffs (2):
// (dlambda1, dlambda2) for Burgers, (0, dvisc) for Euler. `partials` holds
// 2 x ceil(n / 256) doubles of scratch.
extern "C" int pinns_weakform_flux_backward(int kind, int viscous, const float* gr,
                                            const float* y, const float* yx, const float* hxe,
                                            const float* hte, const float* coeffs, int n, int q,
                                            const float* weights, float* gy, float* gyx,
                                            double* partials, int partial_blocks,
                                            float* g_coeffs, int device, void* stream) {
  const int blocks = k7b::blocks_for(n);
  if (n < 1 || q < 1 || q > k7b::kMaxQuad || kind < 0 || kind > 1 ||
      (viscous && (!yx || !gyx)) || partial_blocks != blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K7B_CHECK(cudaSetDevice(device));
  const k7b::Quad w = k7b::to_quad(weights, q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (viscous) {
      k7b::burgers_backward_kernel<true><<<blocks, k7b::kBlock, 0, s>>>(
          gr, y, yx, hxe, hte, coeffs, n, q, w, gy, gyx, partials);
    } else {
      k7b::burgers_backward_kernel<false><<<blocks, k7b::kBlock, 0, s>>>(
          gr, y, yx, hxe, hte, coeffs, n, q, w, gy, gyx, partials);
    }
  } else if (viscous) {
    k7b::euler_backward_kernel<true><<<blocks, k7b::kBlock, 0, s>>>(
        gr, y, yx, hxe, hte, coeffs, n, q, w, gy, gyx, partials);
  } else {
    k7b::euler_backward_kernel<false><<<blocks, k7b::kBlock, 0, s>>>(
        gr, y, yx, hxe, hte, coeffs, n, q, w, gy, gyx, partials);
  }
  K7B_CHECK(cudaGetLastError());
  k7b::sum_partials_kernel<<<1, 32, 0, s>>>(partials, blocks, g_coeffs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_weakform_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
