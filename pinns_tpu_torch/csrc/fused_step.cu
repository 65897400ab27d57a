// One whole Adam epoch of the Burgers PINN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `make_fused_adam_step` / `_step_kernel`
// (pinns_tpu/ops/pallas/fused_step.py at git 3266821^, lines 178-440). It
// computes what pinns_tpu/train/trainer.py::make_adam_step computes for a
// Burgers strong-form config in its scope (ops/kernels/fused_step.py::
// fused_step_supported), in the reference's order:
//
//   loss + gradient at the current batch (data forward on the N_u points,
//   Taylor-2 residual f = u_t + l1 u u_x - l2 u_xx on the N_f points)
//   -> Adam (optax semantics) -> uniform resampling of the batch
//   -> residual at the new points with the new params -> ADMM z/dual
//   -> metrics (loss, data_term, res_term, admm_misfit).
//
// The TPU kernel took its gradient from jax.value_and_grad traced inside the
// kernel. CUDA has no AD, so the reverse mode of the Taylor-2 recurrence is
// written out here. For a hidden layer with s = tanh p, s' = 1 - s^2,
// s'' = -2 s s' and output adjoints (gh, ghx, ght, ghxx):
//   gpxx = ghxx s'              gpx = ghx s' + 2 ghxx s'' px
//   gpt  = ght s'               gp  = s' (gh - 2 s (ghx px + ght pt + ghxx pxx)
//                                         + (6 s^2 - 2) ghxx px^2)
// dW = sum over points and streams of H_in^T gP, db = sum gp, and the input
// adjoints are gP W^T. The residual seeds the head: df/du = l1 u_x,
// df/du_x = l1 u, df/du_t = 1, df/du_xx = -l2, times dL/df, which is
// rho (f - z) + dual (+ dual with explicit_inner) for 'admm', 2 f / N_f for
// 'mean_sq' and 'l2_sq_norm', and 2 S sign(f) / N_f for 'l1_sq_norm' with
// S = sum |f| (the kernel seeds 2 sign(f) / N_f and scales by S after the
// reduction). A data point seeds only the value stream, 2 (u - u_data) / N_u.
// ops/kernels/fused_step.py::loss_and_grad_reference is this algorithm in
// plain PyTorch, held against torch.autograd by the CPU tests.
//
// Launches per epoch, all on the caller's stream:
//   1 grad_kernel    one block per tile of points (colloc tiles, then data
//                    tiles). Forward through the hidden layers, keeping the
//                    pre-activation streams P (4 per unit) of every layer in
//                    a global scratch (L2-resident: 2.9 MB at 8x20), then the
//                    backward layer by layer in shared memory. Each block
//                    writes its partial gradient and its partial loss sum;
//                    nothing is summed with atomics.
//   2 adam_kernel    one thread per parameter: sums the partials over blocks
//                    in block order (deterministic: two runs of a step agree
//                    bit for bit), then Adam. Block 0 writes the loss metrics.
//   3 tail_kernel    one block per tile of the new batch: Philox-4x32-10
//                    draws the points (or takes given ones), the Taylor-2
//                    forward with the NEW params gives f, then z/dual and a
//                    partial sum of |f - z|.
//   4 finalize_kernel  admm_misfit = mean |f - z| from the tail partials.
// The Adam and tail arithmetic rounds after every operation (no contraction),
// as the plain PyTorch step does.
//
// What bounds it on the H100: at 8x20 and N_f = 1000, latency: 16 blocks, each
// a chain of ~26 barrier-separated layer phases, plus four launches. At 8x200,
// the fp32 FMA issue rate and the shared-memory loads that feed it (no tensor
// cores: the residual path keeps full fp32). One persistent launch, a CUDA
// graph per chunk, wgmma and TMA staging of the weights are later work.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kR = 4;             // points per thread item (one float4 per stream)
constexpr int kThreads = 256;     // block size of the grad and tail kernels
constexpr int kMetricLoss = 5, kMetricData = 1, kMetricRes = 6, kMetricMisfit = 0;
constexpr int kMetricLam1 = 2, kMetricLam2 = 3, kMetricLbfgs = 4;
enum Kind { kAdmm = 0, kMeanSq = 1, kL2Sq = 2, kL1Sq = 3 };

struct Net {
  int n_layers;
  int max_width;
  int n_params;
  int dims[kMaxLayers + 1];
  int w_off[kMaxLayers];  // offsets of W_l (din x dout, row-major) in the flat params
  int b_off[kMaxLayers];  // offsets of b_l (dout)
};

struct Step {
  const float* params;      // flat W_0, b_0, W_1, ... (as ops/kernels/taylor2.pack_params)
  const float* mu;
  const float* nu;
  const float* x_data;      // (n_u, 2)
  const float* u_data;      // (n_u, 1)
  const float* colloc;      // (n_f, 2): the batch this step trains on
  const float* z;           // (n_f, 1) or null when kind != admm
  const float* dual;
  const float* new_colloc;  // (n_f, 2) given points, or null: draw with Philox
  float* params_out;
  float* mu_out;
  float* nu_out;
  float* colloc_out;
  float* z_out;
  float* dual_out;
  float* metrics;           // 7 floats in trainer.METRIC_KEYS order
  float* grad_out;          // (n_params) reduced gradient, or null
  float* partials;          // scratch [n_grad_blocks][n_params + 1]
  float* pstore;            // scratch [n_grad_blocks][n_layers-1][4][max_width][tile]
  float* tail_partials;     // scratch [n_tail_blocks]
  float lb0, lb1, ub0, ub1, lam1, lam2, rho, lr;
  float one_minus_b1, b1, one_minus_b2, b2, eps, bc1, bc2, threshold;
  int n_u, n_f, kind, explicit_inner, tile, tail_tile, nb_f, nb_u, nb_tail;
  unsigned seed_lo, seed_hi, epoch_lo, epoch_hi;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[kR]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Philox-4x32-10 (Salmon et al., SC'11); data/sampling.py::philox4x32_10
// computes the same words.
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

// Input streams of point slot p: normalized (x, t) and the constant tangents
// (2/(ub0-lb0), 0), (0, 2/(ub1-lb1)); the second-derivative stream is zero.
__device__ __forceinline__ void input_streams(float* buf, int plane, int ts, int p,
                                              float xv, float tv, const Step& st) {
  const float rx = st.ub0 - st.lb0, rt = st.ub1 - st.lb1;
  buf[0 * plane + 0 * ts + p] = 2.0f * (xv - st.lb0) / rx - 1.0f;
  buf[0 * plane + 1 * ts + p] = 2.0f * (tv - st.lb1) / rt - 1.0f;
  buf[1 * plane + 0 * ts + p] = 2.0f / rx;
  buf[1 * plane + 1 * ts + p] = 0.0f;
  buf[2 * plane + 0 * ts + p] = 0.0f;
  buf[2 * plane + 1 * ts + p] = 2.0f / rt;
  buf[3 * plane + 0 * ts + p] = 0.0f;
  buf[3 * plane + 1 * ts + p] = 0.0f;
}

// Taylor-2 forward through the hidden layers of a tile whose input streams
// are in `in`. Stores each layer's pre-activation streams in `pstore` when it
// is not null. Returns the buffer that holds the last hidden layer's output.
__device__ float* hidden_forward(const Net& net, const float* __restrict__ params,
                                 float* in, float* out, int tile, int ts, int plane,
                                 float* __restrict__ pstore) {
  const int groups = tile / kR;
  for (int l = 0; l < net.n_layers - 1; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* __restrict__ W = params + net.w_off[l];
    const float* __restrict__ b = params + net.b_off[l];
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      float a[kR] = {0.f, 0.f, 0.f, 0.f}, ax[kR] = {0.f, 0.f, 0.f, 0.f};
      float at[kR] = {0.f, 0.f, 0.f, 0.f}, axx[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const float w = __ldg(W + k * dout + j);
        const float4 h = ld4(in + 0 * plane + k * ts + pc);
        const float4 hx = ld4(in + 1 * plane + k * ts + pc);
        const float4 ht = ld4(in + 2 * plane + k * ts + pc);
        const float4 hxx = ld4(in + 3 * plane + k * ts + pc);
        a[0] = fmaf(h.x, w, a[0]);     a[1] = fmaf(h.y, w, a[1]);
        a[2] = fmaf(h.z, w, a[2]);     a[3] = fmaf(h.w, w, a[3]);
        ax[0] = fmaf(hx.x, w, ax[0]);  ax[1] = fmaf(hx.y, w, ax[1]);
        ax[2] = fmaf(hx.z, w, ax[2]);  ax[3] = fmaf(hx.w, w, ax[3]);
        at[0] = fmaf(ht.x, w, at[0]);  at[1] = fmaf(ht.y, w, at[1]);
        at[2] = fmaf(ht.z, w, at[2]);  at[3] = fmaf(ht.w, w, at[3]);
        axx[0] = fmaf(hxx.x, w, axx[0]);  axx[1] = fmaf(hxx.y, w, axx[1]);
        axx[2] = fmaf(hxx.z, w, axx[2]);  axx[3] = fmaf(hxx.w, w, axx[3]);
      }
      const float bj = b[j];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] += bj;
      if (pstore != nullptr) {
        float* P = pstore + (static_cast<long long>(l) * 4 * net.max_width + j) * tile + pc;
        const long long sstride = static_cast<long long>(net.max_width) * tile;
        st4(P + 0 * sstride, a);
        st4(P + 1 * sstride, ax);
        st4(P + 2 * sstride, at);
        st4(P + 3 * sstride, axx);
      }
      float s[kR], sxo[kR], sto[kR], sxxo[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float t = tanhf(a[r]);
        const float d1 = 1.0f - t * t;
        const float d2 = -2.0f * t * d1;
        s[r] = t;
        sxo[r] = d1 * ax[r];
        sto[r] = d1 * at[r];
        sxxo[r] = d2 * ax[r] * ax[r] + d1 * axx[r];
      }
      st4(out + 0 * plane + j * ts + pc, s);
      st4(out + 1 * plane + j * ts + pc, sxo);
      st4(out + 2 * plane + j * ts + pc, sto);
      st4(out + 3 * plane + j * ts + pc, sxxo);
    }
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// Head (dout == 1) of point group g: (u, u_x, u_t, u_xx) of its 4 points.
__device__ __forceinline__ void head(const Net& net, const float* __restrict__ params,
                                     const float* in, int ts, int plane, int pc,
                                     float (&u)[kR], float (&ux)[kR], float (&ut)[kR],
                                     float (&uxx)[kR]) {
  const int l = net.n_layers - 1;
  const int din = net.dims[l];
  const float* __restrict__ W = params + net.w_off[l];
  const float b = params[net.b_off[l]];
#pragma unroll
  for (int r = 0; r < kR; ++r) u[r] = ux[r] = ut[r] = uxx[r] = 0.0f;
  for (int k = 0; k < din; ++k) {
    const float w = __ldg(W + k);
    const float4 h = ld4(in + 0 * plane + k * ts + pc);
    const float4 hx = ld4(in + 1 * plane + k * ts + pc);
    const float4 ht = ld4(in + 2 * plane + k * ts + pc);
    const float4 hxx = ld4(in + 3 * plane + k * ts + pc);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      u[r] = fmaf(get(h, r), w, u[r]);
      ux[r] = fmaf(get(hx, r), w, ux[r]);
      ut[r] = fmaf(get(ht, r), w, ut[r]);
      uxx[r] = fmaf(get(hxx, r), w, uxx[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) u[r] += b;
}

// Deterministic block sum of red[0..n): thread 0 adds in index order.
__device__ __forceinline__ float block_sum_ordered(const float* red, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
grad_kernel(Net net, Step st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = st.tile, ts = T + 4;
  const int plane = net.max_width * ts;
  float* bufA = smem;
  float* bufB = smem + 4 * plane;
  float* bufG = smem + 8 * plane;
  float* red = smem + 12 * plane;  // T floats
  const bool data_blk = blockIdx.x >= static_cast<unsigned>(st.nb_f);
  const int local = data_blk ? blockIdx.x - st.nb_f : blockIdx.x;
  const int n_pts = data_blk ? st.n_u : st.n_f;
  const float* pts = data_blk ? st.x_data : st.colloc;
  const int p0 = local * T;
  const int L = net.n_layers;
  float* pstore = st.pstore +
      static_cast<long long>(blockIdx.x) * (L - 1) * 4 * net.max_width * T;
  float* part = st.partials + static_cast<long long>(blockIdx.x) * (net.n_params + 1);
  const float* __restrict__ params = st.params;

  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p0 + p < n_pts) {
      xv = pts[2 * (p0 + p)];
      tv = pts[2 * (p0 + p) + 1];
    }
    input_streams(bufA, plane, ts, p, xv, tv, st);
  }
  __syncthreads();
  float* X = hidden_forward(net, params, bufA, bufB, T, ts, plane, pstore);
  float* Y = X == bufA ? bufB : bufA;
  float* G = bufG;

  // Head and seeds: the adjoints of (u, u_x, u_t, u_xx), one row each of G.
  for (int g = threadIdx.x; g < T / kR; g += blockDim.x) {
    const int pc = g * kR;
    float u[kR], ux[kR], ut[kR], uxx[kR];
    head(net, params, X, ts, plane, pc, u, ux, ut, uxx);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = p0 + pc + r;
      float gu = 0.0f, gux = 0.0f, gut = 0.0f, guxx = 0.0f, val = 0.0f;
      if (i < n_pts) {
        if (data_blk) {
          const float d = u[r] - st.u_data[i];
          gu = 2.0f * d / static_cast<float>(st.n_u);
          val = d * d;
        } else {
          const float f = ut[r] + st.lam1 * u[r] * ux[r] - st.lam2 * uxx[r];
          float gf;
          if (st.kind == kAdmm) {
            const float dual = st.dual[i];
            const float q = f - st.z[i] + dual / st.rho;
            gf = st.rho * q;
            val = 0.5f * st.rho * q * q;
            if (st.explicit_inner) {
              gf += dual;
              val += dual * f;
            }
          } else if (st.kind == kL1Sq) {
            gf = 2.0f * static_cast<float>((f > 0.0f) - (f < 0.0f)) / static_cast<float>(st.n_f);
            val = fabsf(f);
          } else {  // mean_sq, l2_sq_norm
            gf = 2.0f * f / static_cast<float>(st.n_f);
            val = f * f;
          }
          gu = gf * st.lam1 * ux[r];
          gux = gf * st.lam1 * u[r];
          gut = gf;
          guxx = -st.lam2 * gf;
        }
      }
      G[0 * plane + pc + r] = gu;
      G[1 * plane + pc + r] = gux;
      G[2 * plane + pc + r] = gut;
      G[3 * plane + pc + r] = guxx;
      red[pc + r] = val;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) part[net.n_params] = block_sum_ordered(red, T);

  // Backward, head first. X holds the layer's input streams, G the adjoints
  // of its pre-activation streams; Y receives those of the layer below.
  const int groups = T / kR;
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    if (l < L - 1) {
      // recompute the input streams of layer l
      if (l == 0) {
        for (int p = threadIdx.x; p < T; p += blockDim.x) {
          float xv = 0.0f, tv = 0.0f;
          if (p0 + p < n_pts) {
            xv = pts[2 * (p0 + p)];
            tv = pts[2 * (p0 + p) + 1];
          }
          input_streams(X, plane, ts, p, xv, tv, st);
        }
      } else {
        const float* P = pstore + static_cast<long long>(l - 1) * 4 * net.max_width * T;
        const long long sstride = static_cast<long long>(net.max_width) * T;
        for (int e = threadIdx.x; e < din * T; e += blockDim.x) {
          const int k = e / T, t = e - k * T;
          const float p = P[k * T + t], px = P[sstride + k * T + t];
          const float pt = P[2 * sstride + k * T + t], pxx = P[3 * sstride + k * T + t];
          const float s = tanhf(p), d1 = 1.0f - s * s, d2 = -2.0f * s * d1;
          X[0 * plane + k * ts + t] = s;
          X[1 * plane + k * ts + t] = d1 * px;
          X[2 * plane + k * ts + t] = d1 * pt;
          X[3 * plane + k * ts + t] = d2 * px * px + d1 * pxx;
        }
      }
      __syncthreads();
    }
    const float* __restrict__ W = params + net.w_off[l];
    const int n_wgrad = din * dout + dout;
    const int n_items = n_wgrad + (l > 0 ? din * groups : 0);
    const float* Pb = l > 0 ? pstore + static_cast<long long>(l - 1) * 4 * net.max_width * T
                            : nullptr;
    const long long sstride = static_cast<long long>(net.max_width) * T;
    for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
      if (item < din * dout) {
        // dW[k][j] = sum_t sum_s X[s][k][t] G[s][j][t]
        const int k = item / dout, j = item - k * dout;
        float acc = 0.0f;
        for (int t = 0; t < T; t += kR) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float4 xv = ld4(X + s * plane + k * ts + t);
            const float4 gv = ld4(G + s * plane + j * ts + t);
            acc = fmaf(xv.x, gv.x, acc);
            acc = fmaf(xv.y, gv.y, acc);
            acc = fmaf(xv.z, gv.z, acc);
            acc = fmaf(xv.w, gv.w, acc);
          }
        }
        part[net.w_off[l] + item] = acc;
      } else if (item < n_wgrad) {
        // db[j] = sum_t G[0][j][t]
        const int j = item - din * dout;
        float acc = 0.0f;
        for (int t = 0; t < T; ++t) acc += G[j * ts + t];
        part[net.b_off[l] + j] = acc;
      } else {
        // adjoints of layer l's inputs (gH = gP W^T), then through the tanh
        // of layer l-1 to that layer's pre-activations
        const int e = item - n_wgrad;
        const int g = e / din, k = e - g * din;
        const int pc = g * kR;
        float gh[kR] = {0.f, 0.f, 0.f, 0.f}, ghx[kR] = {0.f, 0.f, 0.f, 0.f};
        float ght[kR] = {0.f, 0.f, 0.f, 0.f}, ghxx[kR] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < dout; ++j) {
          const float w = __ldg(W + k * dout + j);
          const float4 g0 = ld4(G + 0 * plane + j * ts + pc);
          const float4 g1 = ld4(G + 1 * plane + j * ts + pc);
          const float4 g2 = ld4(G + 2 * plane + j * ts + pc);
          const float4 g3 = ld4(G + 3 * plane + j * ts + pc);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            gh[r] = fmaf(get(g0, r), w, gh[r]);
            ghx[r] = fmaf(get(g1, r), w, ghx[r]);
            ght[r] = fmaf(get(g2, r), w, ght[r]);
            ghxx[r] = fmaf(get(g3, r), w, ghxx[r]);
          }
        }
        const float4 p = ld4(Pb + k * T + pc);
        const float4 px = ld4(Pb + sstride + k * T + pc);
        const float4 pt = ld4(Pb + 2 * sstride + k * T + pc);
        const float4 pxx = ld4(Pb + 3 * sstride + k * T + pc);
        float o0[kR], o1[kR], o2[kR], o3[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float pr = get(p, r), pxr = get(px, r), ptr = get(pt, r), pxxr = get(pxx, r);
          const float s = tanhf(pr), d1 = 1.0f - s * s, d2 = -2.0f * s * d1;
          o3[r] = ghxx[r] * d1;
          o1[r] = ghx[r] * d1 + 2.0f * ghxx[r] * d2 * pxr;
          o2[r] = ght[r] * d1;
          o0[r] = d1 * (gh[r] - 2.0f * s * (ghx[r] * pxr + ght[r] * ptr + ghxx[r] * pxxr) +
                        (6.0f * s * s - 2.0f) * ghxx[r] * pxr * pxr);
        }
        st4(Y + 0 * plane + k * ts + pc, o0);
        st4(Y + 1 * plane + k * ts + pc, o1);
        st4(Y + 2 * plane + k * ts + pc, o2);
        st4(Y + 3 * plane + k * ts + pc, o3);
      }
    }
    __syncthreads();
    float* tmp = G;
    G = Y;
    Y = tmp;
  }
}

// One thread per parameter: the gradient summed over blocks in block order,
// then Adam (optax's scale_by_adam + scale(-lr)), one rounding per operation.
__global__ void adam_kernel(Net net, Step st) {
  const int nb = st.nb_f + st.nb_u;
  const long long row = net.n_params + 1;
  float S = 0.0f, D = 0.0f;
  for (int b = 0; b < st.nb_f; ++b) S += st.partials[b * row + net.n_params];
  for (int b = st.nb_f; b < nb; ++b) D += st.partials[b * row + net.n_params];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    const float n_f = static_cast<float>(st.n_f);
    const float data_term = D / static_cast<float>(st.n_u);
    float res_term = S;  // admm: sum of the per-point penalties
    if (st.kind == kMeanSq || st.kind == kL2Sq) res_term = S / n_f;
    if (st.kind == kL1Sq) res_term = S * S / n_f;
    st.metrics[kMetricData] = data_term;
    st.metrics[kMetricRes] = res_term;
    st.metrics[kMetricLoss] = data_term + res_term;
    st.metrics[kMetricLam1] = st.lam1;
    st.metrics[kMetricLam2] = st.lam2;
    st.metrics[kMetricLbfgs] = 0.0f;
  }
  if (i >= net.n_params) return;
  float g_res = 0.0f, g_dat = 0.0f;
  for (int b = 0; b < st.nb_f; ++b) g_res += st.partials[b * row + i];
  for (int b = st.nb_f; b < nb; ++b) g_dat += st.partials[b * row + i];
  const float g = st.kind == kL1Sq ? __fadd_rn(__fmul_rn(S, g_res), g_dat)
                                   : __fadd_rn(g_res, g_dat);
  if (st.grad_out != nullptr) st.grad_out[i] = g;
  const float m = __fadd_rn(__fmul_rn(st.one_minus_b1, g), __fmul_rn(st.b1, st.mu[i]));
  const float v = __fadd_rn(__fmul_rn(st.one_minus_b2, __fmul_rn(g, g)),
                            __fmul_rn(st.b2, st.nu[i]));
  const float mhat = __fdiv_rn(m, st.bc1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, st.bc2)), st.eps);
  const float upd = __fmul_rn(-st.lr, __fdiv_rn(mhat, den));
  st.mu_out[i] = m;
  st.nu_out[i] = v;
  st.params_out[i] = __fadd_rn(st.params[i], upd);
}

// The new batch, then (for 'admm') z/dual at it with the new params.
__global__ void __launch_bounds__(kThreads)
tail_kernel(Net net, Step st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = st.tail_tile, ts = T + 4;
  const int plane = net.max_width * ts;
  float* bufA = smem;
  float* bufB = smem + 4 * plane;
  float* red = smem + 8 * plane;
  const int p0 = blockIdx.x * T;
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const int i = p0 + p;
    float xv = 0.0f, tv = 0.0f;
    if (i < st.n_f) {
      if (st.new_colloc != nullptr) {
        xv = st.new_colloc[2 * i];
        tv = st.new_colloc[2 * i + 1];
      } else {
        const uint4 w = philox4x32_10(
            make_uint4(static_cast<unsigned>(i), st.epoch_lo, st.epoch_hi, 0u),
            make_uint2(st.seed_lo, st.seed_hi));
        const float u0 = static_cast<float>(w.x >> 8) * 5.9604644775390625e-08f;
        const float u1 = static_cast<float>(w.y >> 8) * 5.9604644775390625e-08f;
        xv = __fadd_rn(st.lb0, __fmul_rn(__fsub_rn(st.ub0, st.lb0), u0));
        tv = __fadd_rn(st.lb1, __fmul_rn(__fsub_rn(st.ub1, st.lb1), u1));
      }
      st.colloc_out[2 * i] = xv;
      st.colloc_out[2 * i + 1] = tv;
    }
    input_streams(bufA, plane, ts, p, xv, tv, st);
  }
  if (st.kind != kAdmm) return;  // no ADMM state: the tail only draws
  __syncthreads();
  const float* X = hidden_forward(net, st.params_out, bufA, bufB, T, ts, plane, nullptr);
  for (int g = threadIdx.x; g < T / kR; g += blockDim.x) {
    const int pc = g * kR;
    float u[kR], ux[kR], ut[kR], uxx[kR];
    head(net, st.params_out, X, ts, plane, pc, u, ux, ut, uxx);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = p0 + pc + r;
      float val = 0.0f;
      if (i < st.n_f) {
        const float f = ut[r] + st.lam1 * u[r] * ux[r] - st.lam2 * uxx[r];
        const float dual = st.dual[i];
        const float v = __fadd_rn(f, __fdiv_rn(dual, st.rho));
        const float mag = fmaxf(__fsub_rn(fabsf(v), st.threshold), 0.0f);
        const float z = static_cast<float>((v > 0.0f) - (v < 0.0f)) * mag;
        st.z_out[i] = z;
        st.dual_out[i] = __fadd_rn(dual, __fmul_rn(st.rho, __fsub_rn(f, z)));
        val = fabsf(__fsub_rn(f, z));
      }
      red[pc + r] = val;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) st.tail_partials[blockIdx.x] = block_sum_ordered(red, T);
}

__global__ void finalize_kernel(Step st) {
  if (threadIdx.x != 0) return;
  float mis = 0.0f;
  if (st.kind == kAdmm) {
    for (int b = 0; b < st.nb_tail; ++b) mis += st.tail_partials[b];
    mis /= static_cast<float>(st.n_f);
  }
  st.metrics[kMetricMisfit] = mis;
}

size_t grad_smem(int max_width, int tile) {
  return sizeof(float) * (12u * static_cast<size_t>(max_width) * (tile + 4) + tile);
}

size_t tail_smem(int max_width, int tile) {
  return sizeof(float) * (8u * static_cast<size_t>(max_width) * (tile + 4) + tile);
}

}  // namespace

// Indices of the pointer, float and int argument arrays
// (ops/kernels/fused_step.py builds them in this order).
enum PtrArg {
  kParams, kMu, kNu, kXData, kUData, kColloc, kZ, kDual, kNewColloc,
  kParamsOut, kMuOut, kNuOut, kCollocOut, kZOut, kDualOut, kMetrics, kGradOut,
  kPartials, kPstore, kTailPartials, kNumPtrs
};
enum FloatArg {
  kLb0, kLb1, kUb0, kUb1, kLam1, kLam2, kRho, kLr, kOneMinusB1, kB1, kOneMinusB2,
  kB2, kEps, kBc1, kBc2, kThreshold, kNumFloats
};
enum IntArg {
  kNU, kNF, kKind, kExplicit, kTile, kTailTile, kSeed, kEpoch, kDevice, kNumInts
};

extern "C" int pinns_fused_step_sizes(int* n_ptrs, int* n_floats, int* n_ints) {
  *n_ptrs = kNumPtrs;
  *n_floats = kNumFloats;
  *n_ints = kNumInts;
  return 0;
}

// One epoch on `stream`. `dims` (host) holds n_layers + 1 widths; the other
// arrays follow the enums above. All device buffers are float32, contiguous,
// on device `ints[kDevice]`; the wrapper validated their shapes. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int pinns_fused_step(const int* dims, int n_layers, const long long* ptrs,
                                const float* floats, const long long* ints, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || dims[0] != 2 || dims[n_layers] != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = static_cast<int>(ints[kTile]);
  const int tail_tile = static_cast<int>(ints[kTailTile]);
  if (tile < kR || tile % kR || tail_tile < kR || tail_tile % kR || ints[kNU] < 1 ||
      ints[kNF] < 1 || ints[kKind] < 0 || ints[kKind] > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net;
  net.n_layers = n_layers;
  net.max_width = 0;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.dims[l] = dims[l];
    if (dims[l] > net.max_width) net.max_width = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net.w_off[l] = off;
    off += dims[l] * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
  }
  net.n_params = off;

  auto fp = [&](int k) { return reinterpret_cast<float*>(ptrs[k]); };
  Step st;
  st.params = fp(kParams);
  st.mu = fp(kMu);
  st.nu = fp(kNu);
  st.x_data = fp(kXData);
  st.u_data = fp(kUData);
  st.colloc = fp(kColloc);
  st.z = fp(kZ);
  st.dual = fp(kDual);
  st.new_colloc = fp(kNewColloc);
  st.params_out = fp(kParamsOut);
  st.mu_out = fp(kMuOut);
  st.nu_out = fp(kNuOut);
  st.colloc_out = fp(kCollocOut);
  st.z_out = fp(kZOut);
  st.dual_out = fp(kDualOut);
  st.metrics = fp(kMetrics);
  st.grad_out = fp(kGradOut);
  st.partials = fp(kPartials);
  st.pstore = fp(kPstore);
  st.tail_partials = fp(kTailPartials);
  st.lb0 = floats[kLb0];
  st.lb1 = floats[kLb1];
  st.ub0 = floats[kUb0];
  st.ub1 = floats[kUb1];
  st.lam1 = floats[kLam1];
  st.lam2 = floats[kLam2];
  st.rho = floats[kRho];
  st.lr = floats[kLr];
  st.one_minus_b1 = floats[kOneMinusB1];
  st.b1 = floats[kB1];
  st.one_minus_b2 = floats[kOneMinusB2];
  st.b2 = floats[kB2];
  st.eps = floats[kEps];
  st.bc1 = floats[kBc1];
  st.bc2 = floats[kBc2];
  st.threshold = floats[kThreshold];
  st.n_u = static_cast<int>(ints[kNU]);
  st.n_f = static_cast<int>(ints[kNF]);
  st.kind = static_cast<int>(ints[kKind]);
  st.explicit_inner = static_cast<int>(ints[kExplicit]);
  st.tile = tile;
  st.tail_tile = tail_tile;
  st.nb_f = (st.n_f + tile - 1) / tile;
  st.nb_u = (st.n_u + tile - 1) / tile;
  st.nb_tail = (st.n_f + tail_tile - 1) / tail_tile;
  const unsigned long long seed = static_cast<unsigned long long>(ints[kSeed]);
  const unsigned long long epoch = static_cast<unsigned long long>(ints[kEpoch]);
  st.seed_lo = static_cast<unsigned>(seed & 0xFFFFFFFFull);
  st.seed_hi = static_cast<unsigned>(seed >> 32);
  st.epoch_lo = static_cast<unsigned>(epoch & 0xFFFFFFFFull);
  st.epoch_hi = static_cast<unsigned>(epoch >> 32);

  cudaError_t err = cudaSetDevice(static_cast<int>(ints[kDevice]));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t gsm = grad_smem(net.max_width, tile);
  const size_t tsm = tail_smem(net.max_width, tail_tile);
  err = cudaFuncSetAttribute(grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gsm));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tsm));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grad_kernel<<<st.nb_f + st.nb_u, kThreads, gsm, s>>>(net, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(net, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_kernel<<<st.nb_tail, kThreads, tsm, s>>>(net, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<1, 32, 0, s>>>(st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
