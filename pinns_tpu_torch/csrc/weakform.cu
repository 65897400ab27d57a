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
// dU/dx, p = (gamma - 1)(E - rho u^2 / 2). In its entropy mode the same
// quadrature of the cell's entropy pair gives the weak entropy violation
//   ent = relu(e)^2,  e = (hxe sum_q w_q (eta_top - eta_bot)
//                         + hte sum_q w_q (G_right - G_left)) / (4 hxe hte)
// with Burgers' eta = u^2 / 2, G = lambda1 u^3 / 3 - lambda2 u u_x, or the
// Euler system's eta = -rho S / (gamma - 1), G = u eta - visc eta_x, S =
// log max(p, 1e-3) - gamma log max(rho, 1e-3) (the viscous terms only when
// viscous). ops/weakform.py holds the plain PyTorch versions
// (edge_points_reference, burgers_quadrature_reference,
// euler_quadrature_reference).
//
// Three launches a training step (the net between them is K7a or K5):
//   edge_points   one thread per (cell, edge, node): the points (N 4Q, 2) in
//                 JAX's row order cell 4Q + edge Q + q, edges [bottom t1,
//                 top t2, left x1, right x2], and the clipped half-widths
//                 hxe, hte (N);
//   flux_forward  one thread per cell, templated on the equation (C = 1
//                 Burgers, C = 3 Euler), on the viscous term and on the
//                 entropy mode: r (N, C), and in the entropy mode e and
//                 relu(e)^2 (N) from the same pass over the cell's rows;
//   flux_backward one thread per cell: from g_r (N, C) (and g_ent (N) in
//                 the entropy mode, through d relu(e)^2 / de = 2 relu(e))
//                 the cotangents of the net's values and x-derivatives
//                 (N 4Q, C), and per-block partial sums, in double, of the
//                 coefficients' gradient (lambda1, lambda2 for Burgers; visc
//                 for Euler); a second launch of one thread per coefficient
//                 sums the partials in block order. No atomics: two calls
//                 agree bit for bit. The clamps under the logs pass half
//                 the gradient at a tie, as torch.maximum and JAX's
//                 jnp.maximum do.
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
// quadrature into its head is later speed work. The entropy mode reads the
// same rows in the same pass (two logs a row for Euler) and writes two more
// floats a cell, so it moves the bound by N 8 bytes. Every kernel is in
// namespace k7b, so a profile tells them apart.

#include <cuda_runtime.h>

namespace {
namespace k7b {

constexpr int kMaxQuad = 8;
constexpr int kBlock = 256;
constexpr int kCoeffs = 2;
constexpr float kEps = 1e-3f;  // the floor of p and rho under the entropy's logs

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

// The Euler entropy eta = -rho S / (gamma - 1) at one edge row, S = log
// max(p, eps) - gamma log max(rho, eps) (the plain version's
// euler_conserved_flux); *s_out takes S.
__device__ __forceinline__ float euler_eta(const float* __restrict__ y, long long row, float gm1,
                                           float gamma, float* s_out) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  const float p = __fmul_rn(gm1, __fsub_rn(e, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, rho), u), u)));
  const float s = __fsub_rn(logf(fmaxf(p, kEps)), __fmul_rn(gamma, logf(fmaxf(rho, kEps))));
  *s_out = s;
  return __fdiv_rn(__fmul_rn(-rho, s), gm1);
}

// d(eta)/dx at one side-edge row (the plain version's euler_entropy_x).
__device__ __forceinline__ float euler_eta_x(const float* __restrict__ y,
                                             const float* __restrict__ yx, long long row,
                                             float gm1, float gamma, float s) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  const float rho_x = yx[3 * row], u_x = yx[3 * row + 1], e_x = yx[3 * row + 2];
  const float p = __fmul_rn(gm1, __fsub_rn(e, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, rho), u), u)));
  const float p_safe = fmaxf(p, kEps), rho_safe = fmaxf(rho, kEps);
  const float p_x = __fmul_rn(
      gm1, __fsub_rn(__fsub_rn(e_x, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, u), u), rho_x)),
                     __fmul_rn(__fmul_rn(rho, u), u_x)));
  const float s_x = __fsub_rn(__fdiv_rn(p_x, p_safe), __fdiv_rn(__fmul_rn(gamma, rho_x), rho_safe));
  return __fdiv_rn(-__fadd_rn(__fmul_rn(rho_x, s), __fmul_rn(rho, s_x)), gm1);
}

// The Burgers entropy pair's differences at node k: (eta_top - eta_bot,
// G_right - G_left).
template <bool kViscous>
__device__ __forceinline__ void burgers_entropy_diffs(const float* __restrict__ y,
                                                      const float* __restrict__ yx, long long bot,
                                                      long long top, long long lef,
                                                      long long rig, float lam1_3, float lam2,
                                                      float* d_eta, float* d_g) {
  const float ub = y[bot], ut = y[top], ul = y[lef], ur = y[rig];
  *d_eta = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(ut, ut), __fmul_rn(ub, ub)));
  float g = __fmul_rn(lam1_3, __fsub_rn(__fmul_rn(__fmul_rn(ur, ur), ur),
                                        __fmul_rn(__fmul_rn(ul, ul), ul)));
  if constexpr (kViscous) {
    g = __fsub_rn(g, __fmul_rn(lam2, __fsub_rn(__fmul_rn(ur, yx[rig]), __fmul_rn(ul, yx[lef]))));
  }
  *d_g = g;
}

// The Euler entropy pair's differences at node k.
template <bool kViscous>
__device__ __forceinline__ void euler_entropy_diffs(const float* __restrict__ y,
                                                    const float* __restrict__ yx, long long bot,
                                                    long long top, long long lef, long long rig,
                                                    float gm1, float gamma, float visc,
                                                    float* d_eta, float* d_g) {
  float sb, st, sl, sr;
  const float eb = euler_eta(y, bot, gm1, gamma, &sb), et = euler_eta(y, top, gm1, gamma, &st);
  const float el = euler_eta(y, lef, gm1, gamma, &sl), er = euler_eta(y, rig, gm1, gamma, &sr);
  *d_eta = __fsub_rn(et, eb);
  float g = __fsub_rn(__fmul_rn(y[3 * rig + 1], er), __fmul_rn(y[3 * lef + 1], el));
  if constexpr (kViscous) {
    g = __fsub_rn(g, __fmul_rn(visc, __fsub_rn(euler_eta_x(y, yx, rig, gm1, gamma, sr),
                                               euler_eta_x(y, yx, lef, gm1, gamma, sl))));
  }
  *d_g = g;
}

template <int C, bool kViscous, bool kEntropy>
__global__ void flux_forward_kernel(const float* __restrict__ y, const float* __restrict__ yx,
                                    const float* __restrict__ hxe, const float* __restrict__ hte,
                                    const float* __restrict__ coeffs, float gamma, int n, int q,
                                    Quad w, float* __restrict__ r, float* __restrict__ ent,
                                    float* __restrict__ e_out) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const long long base = static_cast<long long>(cell) * 4 * q;
  const float c0 = coeffs[0], c1 = coeffs[1];
  float s1[C], s2[C], se1 = 0.0f, se2 = 0.0f;
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
    if constexpr (kEntropy) {
      float d_eta, d_g;
      if constexpr (C == 1) {
        burgers_entropy_diffs<kViscous>(y, yx, bot, top, lef, rig, __fdiv_rn(c0, 3.0f), c1,
                                        &d_eta, &d_g);
      } else {
        euler_entropy_diffs<kViscous>(y, yx, bot, top, lef, rig, c0, gamma, c1, &d_eta, &d_g);
      }
      const float a = __fmul_rn(d_eta, w.v[k]), b = __fmul_rn(d_g, w.v[k]);
      se1 = k == 0 ? a : __fadd_rn(se1, a);
      se2 = k == 0 ? b : __fadd_rn(se2, b);
    }
  }
  const float hx = hxe[cell], ht = hte[cell];
  const float measure = __fmul_rn(__fmul_rn(4.0f, hx), ht);
  for (int c = 0; c < C; ++c) {
    r[static_cast<long long>(cell) * C + c] =
        __fdiv_rn(__fadd_rn(__fmul_rn(hx, s1[c]), __fmul_rn(ht, s2[c])), measure);
  }
  if constexpr (kEntropy) {
    const float e = __fdiv_rn(__fadd_rn(__fmul_rn(hx, se1), __fmul_rn(ht, se2)), measure);
    const float m = fmaxf(e, 0.0f);
    e_out[cell] = e;
    ent[cell] = __fmul_rn(m, m);
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

// The entropy's cotangents at a cell (zero outside the entropy mode): (d e
// / d(sum_q w_q d_eta), d e / d(sum_q w_q d_G)) times g_ent 2 relu(e).
template <bool kEntropy>
__device__ __forceinline__ void entropy_cotangents(const float* __restrict__ g_ent,
                                                   const float* __restrict__ e, int cell,
                                                   float hx, float ht, float* ge1, float* ge2) {
  *ge1 = *ge2 = 0.0f;
  if constexpr (kEntropy) {
    const float g_over = g_ent[cell] * 2.0f * fmaxf(e[cell], 0.0f) / (4.0f * hx * ht);
    *ge1 = g_over * hx;
    *ge2 = g_over * ht;
  }
}

// Burgers: g_u, g_ux at the cell's 4Q rows; (dlambda1, dlambda2).
template <bool kViscous, bool kEntropy>
__global__ void burgers_backward_kernel(const float* __restrict__ gr,
                                        const float* __restrict__ g_ent,
                                        const float* __restrict__ e,
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
    float ge1, ge2;
    entropy_cotangents<kEntropy>(g_ent, e, cell, hx, ht, &ge1, &ge2);
    for (int k = 0; k < q; ++k) {
      const long long bot = base + k, top = base + q + k, lef = base + 2 * q + k,
                      rig = base + 3 * q + k;
      const float gc = g1 * w.v[k], gf = g2 * w.v[k];  // top: +gc, right: +gf
      const float ul = y[lef], ur = y[rig];
      float g_bot = -gc, g_top = gc, g_lef = -gf * lam1 * ul, g_rig = gf * lam1 * ur;
      d_lam1 += 0.5 * static_cast<double>(gf) *
                (static_cast<double>(ur) * ur - static_cast<double>(ul) * ul);
      float gx_lef = 0.0f, gx_rig = 0.0f;
      if constexpr (kViscous) {
        gx_lef = gf * lam2;
        gx_rig = -gf * lam2;
        d_lam2 -= static_cast<double>(gf) * (static_cast<double>(yx[rig]) - yx[lef]);
      }
      if constexpr (kEntropy) {  // eta = u^2 / 2, G = lambda1 u^3 / 3 - lambda2 u u_x
        const float gce = ge1 * w.v[k], gfe = ge2 * w.v[k];
        const float ub = y[bot], ut = y[top];
        g_bot -= gce * ub;
        g_top += gce * ut;
        g_lef -= gfe * lam1 * ul * ul;
        g_rig += gfe * lam1 * ur * ur;
        d_lam1 += static_cast<double>(gfe) *
                  (static_cast<double>(ur) * ur * ur - static_cast<double>(ul) * ul * ul) / 3.0;
        if constexpr (kViscous) {
          const float uxl = yx[lef], uxr = yx[rig];
          g_lef += gfe * lam2 * uxl;
          g_rig -= gfe * lam2 * uxr;
          gx_lef += gfe * lam2 * ul;
          gx_rig -= gfe * lam2 * ur;
          d_lam2 -= static_cast<double>(gfe) * (static_cast<double>(ur) * uxr -
                                                static_cast<double>(ul) * uxl);
        }
      }
      gy[bot] = g_bot;
      gy[top] = g_top;
      gy[lef] = g_lef;
      gy[rig] = g_rig;
      if constexpr (kViscous) {
        gyx[bot] = 0.0f;
        gyx[top] = 0.0f;
        gyx[lef] = gx_lef;
        gyx[rig] = gx_rig;
      }
    }
  }
  block_sum(d_lam1, d_lam2, partials);
}

// The half of the gradient a clamp max(v, eps) passes at a tie, as
// torch.maximum and jnp.maximum do: d max(v, eps) / dv.
__device__ __forceinline__ float clamp_slope(float v) {
  return v > kEps ? 1.0f : (v == kEps ? 0.5f : 0.0f);
}

// The Euler entropy's part of a row's cotangents: c_eta on eta (the top and
// bottom rows), c_q on q = u eta and c_etax on eta_x (the side rows) go to
// (rho, u, E) in g[0..2] and, when viscous, (rho_x, u_x, E_x) in gx[0..2];
// returns eta_x (0 unless viscous and a side row) for d/dvisc.
template <bool kViscous, bool kSide>
__device__ __forceinline__ float euler_entropy_row_backward(
    const float* __restrict__ y, const float* __restrict__ yx, long long row, float gm1,
    float gamma, float c_eta, float c_q, float c_etax, float g[3], float gx[3]) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  const float p = gm1 * (e - 0.5f * rho * u * u);
  const float P = fmaxf(p, kEps), R = fmaxf(rho, kEps);
  const float s = logf(P) - gamma * logf(R);
  const float eta = -rho * s / gm1;
  const float c = c_eta + c_q * u;  // eta's whole cotangent (q = u eta)
  g[1] += c_q * eta;
  g[0] += c * (-s / gm1);
  const float g_s = c * (-rho / gm1);
  float gP = g_s / P, gR = -g_s * gamma / R;
  float eta_x = 0.0f;
  if constexpr (kViscous && kSide) {
    const float rho_x = yx[3 * row], u_x = yx[3 * row + 1], e_x = yx[3 * row + 2];
    const float p_x = gm1 * (e_x - 0.5f * u * u * rho_x - rho * u * u_x);
    const float s_x = p_x / P - gamma * rho_x / R;
    eta_x = -(rho_x * s + rho * s_x) / gm1;
    const float g_s2 = c_etax * (-rho_x / gm1), g_sx = c_etax * (-rho / gm1);
    g[0] += c_etax * (-s_x / gm1);
    gx[0] += c_etax * (-s / gm1);
    gP += g_s2 / P - g_sx * p_x / (P * P);
    gR += -g_s2 * gamma / R + g_sx * gamma * rho_x / (R * R);
    gx[0] -= g_sx * gamma / R;
    const float g_px = g_sx / P;  // p_x = gm1 (E_x - u^2 rho_x / 2 - rho u u_x)
    gx[2] += g_px * gm1;
    gx[0] -= g_px * gm1 * 0.5f * u * u;
    gx[1] -= g_px * gm1 * rho * u;
    g[1] -= g_px * gm1 * (u * rho_x + rho * u_x);
    g[0] -= g_px * gm1 * u * u_x;
  }
  const float g_p = gP * clamp_slope(p);  // p = gm1 (E - rho u^2 / 2)
  g[0] += g_p * gm1 * (-0.5f * u * u) + gR * clamp_slope(rho);
  g[1] += g_p * gm1 * (-rho * u);
  g[2] += g_p * gm1;
  return eta_x;
}

// The cotangents of (rho, u, E) (and of their x-derivatives) at one edge
// row from those of its conserved variables (gcons) or fluxes (gflux), and
// in the entropy mode those of its entropy pair (c_eta or c_q, c_etax);
// returns the row's part of d/dvisc.
template <bool kViscous, bool kSide, bool kEntropy>
__device__ __forceinline__ double euler_row_backward(const float* __restrict__ y,
                                                     const float* __restrict__ yx,
                                                     long long row, float gm1, float gamma,
                                                     float visc, const float g[3], float c_ent,
                                                     float* __restrict__ gy,
                                                     float* __restrict__ gyx) {
  const float rho = y[3 * row], u = y[3 * row + 1], e = y[3 * row + 2];
  if constexpr (!kSide) {  // U = (rho, rho u, E)
    float ge[3] = {g[0] + g[1] * u, g[1] * rho, g[2]}, gx[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kEntropy) {
      euler_entropy_row_backward<kViscous, false>(y, yx, row, gm1, gamma, c_ent, 0.0f, 0.0f, ge,
                                                  gx);
    }
    gy[3 * row] = ge[0];
    gy[3 * row + 1] = ge[1];
    gy[3 * row + 2] = ge[2];
    if constexpr (kViscous) gyx[3 * row] = gyx[3 * row + 1] = gyx[3 * row + 2] = 0.0f;
    return 0.0;
  }
  // F = (rho u, rho u^2 + p, u (E + p)), p = gm1 (E - rho u^2 / 2)
  const float p = gm1 * (e - 0.5f * rho * u * u);
  const float dp_drho = -0.5f * gm1 * u * u, dp_du = -gm1 * rho * u;
  float g_rho = g[0] * u + g[1] * (u * u + dp_drho) + g[2] * u * dp_drho;
  float g_u = g[0] * rho + g[1] * (2.0f * rho * u + dp_du) + g[2] * ((e + p) + u * dp_du);
  float g_e = g[1] * gm1 + g[2] * u * (1.0f + gm1);
  double d_visc = 0.0;
  float gx[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kViscous) {  // F -= visc (rho_x, rho_x u + rho u_x, E_x)
    const float rho_x = yx[3 * row], u_x = yx[3 * row + 1], e_x = yx[3 * row + 2];
    g_rho -= visc * g[1] * u_x;
    g_u -= visc * g[1] * rho_x;
    gx[0] = -visc * (g[0] + g[1] * u);
    gx[1] = -visc * g[1] * rho;
    gx[2] = -visc * g[2];
    d_visc = -(static_cast<double>(g[0]) * rho_x +
               static_cast<double>(g[1]) *
                   (static_cast<double>(rho_x) * u + static_cast<double>(rho) * u_x) +
               static_cast<double>(g[2]) * e_x);
  }
  if constexpr (kEntropy) {  // G = q - visc eta_x: c_ent is G's cotangent
    float ge[3] = {g_rho, g_u, g_e};
    const float eta_x = euler_entropy_row_backward<kViscous, true>(
        y, yx, row, gm1, gamma, 0.0f, c_ent, -visc * c_ent, ge, gx);
    g_rho = ge[0];
    g_u = ge[1];
    g_e = ge[2];
    if constexpr (kViscous) d_visc -= static_cast<double>(c_ent) * eta_x;
  }
  if constexpr (kViscous) {
    gyx[3 * row] = gx[0];
    gyx[3 * row + 1] = gx[1];
    gyx[3 * row + 2] = gx[2];
  }
  gy[3 * row] = g_rho;
  gy[3 * row + 1] = g_u;
  gy[3 * row + 2] = g_e;
  return d_visc;
}

// Euler: g_y, g_yx at the cell's 4Q rows; (0, dvisc).
template <bool kViscous, bool kEntropy>
__global__ void euler_backward_kernel(const float* __restrict__ gr,
                                      const float* __restrict__ g_ent,
                                      const float* __restrict__ e, const float* __restrict__ y,
                                      const float* __restrict__ yx,
                                      const float* __restrict__ hxe,
                                      const float* __restrict__ hte,
                                      const float* __restrict__ coeffs, float gamma, int n, int q,
                                      Quad w, float* __restrict__ gy, float* __restrict__ gyx,
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
    float ge1, ge2;
    entropy_cotangents<kEntropy>(g_ent, e, cell, hx, ht, &ge1, &ge2);
    for (int k = 0; k < q; ++k) {
      float pos_c[3], neg_c[3], pos_f[3], neg_f[3];
      for (int c = 0; c < 3; ++c) {
        pos_c[c] = g1[c] * w.v[k];
        neg_c[c] = -pos_c[c];
        pos_f[c] = g2[c] * w.v[k];
        neg_f[c] = -pos_f[c];
      }
      const float gce = ge1 * w.v[k], gfe = ge2 * w.v[k];
      euler_row_backward<kViscous, false, kEntropy>(y, yx, base + k, gm1, gamma, visc, neg_c,
                                                    -gce, gy, gyx);
      euler_row_backward<kViscous, false, kEntropy>(y, yx, base + q + k, gm1, gamma, visc,
                                                    pos_c, gce, gy, gyx);
      d_visc += euler_row_backward<kViscous, true, kEntropy>(y, yx, base + 2 * q + k, gm1, gamma,
                                                             visc, neg_f, -gfe, gy, gyx);
      d_visc += euler_row_backward<kViscous, true, kEntropy>(y, yx, base + 3 * q + k, gm1, gamma,
                                                             visc, pos_f, gfe, gy, gyx);
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

// A kernel template's instance by runtime flags.
#define K7B_DISPATCH2(a, b, CALL) \
  do {                            \
    if (a) {                      \
      if (b) CALL(true, true);    \
      else CALL(true, false);     \
    } else {                      \
      if (b) CALL(false, true);   \
      else CALL(false, false);    \
    }                             \
  } while (0)

// r (n, C) from the net at the edge rows: kind 0 Burgers (C 1, coeffs
// (lambda1, lambda2)), 1 Euler (C 3, coeffs (gamma - 1, visc)); yx is read
// only when `viscous`; `weights` a host array of the q quadrature weights.
// With `entropy`, also e (n) and ent = relu(e)^2 (n); `gamma` is read by the
// Euler entropy only.
extern "C" int pinns_weakform_flux_forward(int kind, int viscous, int entropy, const float* y,
                                           const float* yx, const float* hxe, const float* hte,
                                           const float* coeffs, float gamma, int n, int q,
                                           const float* weights, float* r, float* ent,
                                           float* e, int device, void* stream) {
  if (n < 1 || q < 1 || q > k7b::kMaxQuad || kind < 0 || kind > 1 || (viscous && !yx) ||
      (entropy && (!ent || !e))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K7B_CHECK(cudaSetDevice(device));
  const k7b::Quad w = k7b::to_quad(weights, q);
  const int blocks = k7b::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K7B_FORWARD(C, V, E)                                                             \
  k7b::flux_forward_kernel<C, V, E><<<blocks, k7b::kBlock, 0, s>>>(y, yx, hxe, hte, coeffs, \
                                                                  gamma, n, q, w, r, ent, e)
#define K7B_BURGERS(V, E) K7B_FORWARD(1, V, E)
#define K7B_EULER(V, E) K7B_FORWARD(3, V, E)
  if (kind == 0) {
    K7B_DISPATCH2(viscous, entropy, K7B_BURGERS);
  } else {
    K7B_DISPATCH2(viscous, entropy, K7B_EULER);
  }
#undef K7B_EULER
#undef K7B_BURGERS
#undef K7B_FORWARD
  return static_cast<int>(cudaGetLastError());
}

// From g_r (n, C) (and, with `entropy`, g_ent (n) and the forward's e (n)):
// g_y and (when viscous) g_yx (n 4q, C), and g_coeffs (2): (dlambda1,
// dlambda2) for Burgers, (0, dvisc) for Euler. `partials` holds 2 x ceil(n /
// 256) doubles of scratch.
extern "C" int pinns_weakform_flux_backward(int kind, int viscous, int entropy, const float* gr,
                                            const float* g_ent, const float* e, const float* y,
                                            const float* yx, const float* hxe, const float* hte,
                                            const float* coeffs, float gamma, int n, int q,
                                            const float* weights, float* gy, float* gyx,
                                            double* partials, int partial_blocks,
                                            float* g_coeffs, int device, void* stream) {
  const int blocks = k7b::blocks_for(n);
  if (n < 1 || q < 1 || q > k7b::kMaxQuad || kind < 0 || kind > 1 ||
      (viscous && (!yx || !gyx)) || (entropy && (!g_ent || !e)) || partial_blocks != blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K7B_CHECK(cudaSetDevice(device));
  const k7b::Quad w = k7b::to_quad(weights, q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K7B_BURGERS(V, E)                                                \
  k7b::burgers_backward_kernel<V, E><<<blocks, k7b::kBlock, 0, s>>>(     \
      gr, g_ent, e, y, yx, hxe, hte, coeffs, n, q, w, gy, gyx, partials)
#define K7B_EULER(V, E)                                                         \
  k7b::euler_backward_kernel<V, E><<<blocks, k7b::kBlock, 0, s>>>(              \
      gr, g_ent, e, y, yx, hxe, hte, coeffs, gamma, n, q, w, gy, gyx, partials)
  if (kind == 0) {
    K7B_DISPATCH2(viscous, entropy, K7B_BURGERS);
  } else {
    K7B_DISPATCH2(viscous, entropy, K7B_EULER);
  }
#undef K7B_EULER
#undef K7B_BURGERS
  K7B_CHECK(cudaGetLastError());
  k7b::sum_partials_kernel<<<1, 32, 0, s>>>(partials, blocks, g_coeffs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_weakform_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
