// One whole Adam epoch of the Burgers PINN, for Hopper (sm_90a): K3.
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
// reduction). A data point seeds only the value stream, 2 (u - u_data) / N_u;
// its derivative streams' seeds are 0, and the rules above keep every
// derivative-stream adjoint of such a point exactly 0.
// ops/kernels/fused_step.py::loss_and_grad_reference is this algorithm in
// plain PyTorch, held against torch.autograd by the CPU tests.
//
// Two designs, picked from the widths (ops/kernels/fused_step.py::design);
// one host call of pinns_fused_step issues every launch of an epoch on the
// caller's stream, and neither design uses atomics, so two calls of a step
// agree bit for bit. Every kernel here is in namespace k3, and the engine's
// kernels are instantiated on K3's own tile type, so a profile tells them
// from K2's and K5's.
//
// Narrow (every width <= 32: abgrall_admm's 8x20 and the other 8x20 nets),
// four launches:
//   1 grad_kernel    one block per tile of points (colloc tiles, then data
//                    tiles). Forward through the hidden layers, keeping the
//                    pre-activation streams P (4 per unit) of every layer in
//                    a global scratch (L2-resident: 2.9 MB at 8x20), then the
//                    backward layer by layer in shared memory. Each block
//                    writes its partial gradient and its partial loss sum.
//   2 adam_kernel    one thread per parameter: sums the partials over blocks
//                    in block order, then Adam. Block 0 writes the loss
//                    metrics.
//   3 tail_kernel    one block per tile of the new batch: Philox-4x32-10
//                    draws the points (or takes given ones), the Taylor-2
//                    forward with the NEW params gives f, then z/dual and a
//                    partial sum of |f - z|.
//   4 finalize_kernel  admm_misfit = mean |f - z| from the tail partials.
// What bounds it on the H100 at 8x20 and N_f = 1000: latency: 16 blocks, each
// a chain of ~26 barrier-separated layer phases, plus four launches and the
// host's work between epochs.
//
// K8, the member-batched narrow design (replaces the vmapped step of
// pinns_tpu/parallel/ensemble.py:66-116, jax.vmap(step) over an ensemble's
// members): the same four launches with the member m as blockIdx.y (the
// finalize launch: one block, a thread a member). Member
// m's buffers (params, Adam moments, batch, z/dual, their outputs, its
// metrics row and its scratch) lie at m times their per-member size
// (member_step); its Philox seed, ADMM rho and prox threshold come from
// members[m]; the data, the coefficients, lr, the bias corrections and the
// epoch are shared. The tile plan does not depend on the member count, so
// each member's blocks do exactly the solo call's arithmetic in its order:
// member m of an E-member call equals a solo call of member m bit for bit (a
// solo call is member 0 of a call without a member table). At abgrall_admm's
// 8x20 a solo epoch fills 18 of the card's 396 grad-block slots (3 blocks of
// ~65 KB an SM); E members fill 18 E of them in one launch.
//
// Wide (any wider net: abgrall_l1/l2/visc's 8x200). The whole epoch, layer by
// layer, as dense products over all its points on the engine of
// layer_gemm.cuh, on 32 x 32 block tiles of 64 threads (so that a product
// over the presets' 1,100 points fills the card):
//   stacked batch  the N_f collocation points (padded to nf_pad) and the N_u
//             data points (padded to nu_pad) as one batch, each segment its
//             four streams one after another (Rows); padded points take
//             (0, 0) and zero seeds. Every stacked input carries one more
//             column, 1 on value rows and 0 elsewhere, so that [W_l; b_l]
//             (b_l follows W_l in pack_params order) is one matrix;
//   forward   per hidden layer one product P_l = H_l [W_l; b_l], kept, and a
//             pass that writes H_l+1 by the tanh Taylor rule; the head's
//             product u = H_L-1 [W; b];
//   seeds     one pass: f, dL/df by the kind, the data rows' seeds, the
//             head's db and the loss's per-tile sums (double);
//   backward  K2's: per layer one launch of dW_l = H_l^T G (split over row
//             chunks that never straddle the two segments) paired with
//             gH = G W_l^T, and a pass that applies the tanh rules at P_l-1,
//             sums db_l-1 per 32-point tile in double and recomputes H_l-1;
//   Adam      one thread per parameter: its collocation and data sums in
//             double, each in a fixed order (split order for a weight, tile
//             order for a bias), g = S_l1 res + dat rounded once, then Adam
//             as the narrow design; thread 0 writes the loss metrics;
//   tail      Philox draws the new points as the narrow tail does, the
//             Taylor-2 forward with the new params as products (nothing
//             kept), a pass for f, z, dual and the per-tile sums of
//             |f - z|, and a last launch that writes admm_misfit.
// 57 launches at 8x200 for 'admm' (the tail's forward only runs for it).
// What bounds it on the H100: the operations of its products (about 12
// GFLOP an epoch at 8x200 and 1,100 points, 0.18 ms at the fp32 peak; no
// tensor cores: the residual path keeps full fp32), and the chain of
// dependent launches. One persistent launch or a CUDA graph of the epoch is
// later work.
//
// K9, the chunk as one device program (replaces the lax.scan of
// pinns_tpu/train/trainer.py::make_chunked, :835-870, and of
// pinns_tpu/parallel/ensemble.py::make_ensemble_chunk, :109): with a device
// cursor (Step::cursor), the kernels read the epoch's words (the Philox
// epoch, Adam's bias corrections) from row *cursor of the chunk's schedule,
// write the epoch's row of the metrics and read its row of any given points;
// the last launch of the epoch (finalize_kernel, wide_finalize_kernel)
// advances the cursor. Every other argument of an epoch is fixed, so epochs
// between two fixed state buffers can be captured once as a CUDA graph and
// replayed for every epoch of a chunk (ops/kernels/fused_step.py::
// FusedChunk). With a null cursor every kernel does what the per-epoch call
// does; with one, the same arithmetic, so a replayed chunk equals the
// per-epoch loop bit for bit.
//
// The Adam and tail arithmetic rounds after every operation (no contraction),
// as the plain PyTorch step does.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "layer_gemm.cuh"

namespace {
namespace k3 {

constexpr int kR = 4;             // points per thread item (one float4 per stream)
constexpr int kThreads = 256;     // block size of the grad and tail kernels
constexpr int kNarrowWidth = 32;  // ops/kernels/fused_step.py::NARROW_WIDTH
// the wide design's point tile (ops/kernels/fused_step.py::EW_TILE): each
// segment of the stacked batch is padded to whole tiles; the elementwise
// passes run one thread a (point, unit) in blocks of kPts points x 32 units,
// and db's, the loss's and the tail's sums are taken per tile
constexpr int kPts = kEwRows;
constexpr int kMetricLoss = 5, kMetricData = 1, kMetricRes = 6, kMetricMisfit = 0;
constexpr int kMetricLam1 = 2, kMetricLam2 = 3, kMetricLbfgs = 4;
enum Kind { kAdmm = 0, kMeanSq = 1, kL2Sq = 2, kL1Sq = 3 };

// One member of a member-batched narrow call (K8): its Philox seed's words,
// its ADMM rho and its prox threshold 1/(rho N_f), each as float32.
struct Member {
  unsigned seed_lo, seed_hi;
  float rho, threshold;
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
  float* partials;          // narrow scratch [n_grad_blocks][n_params + 1]
  float* pstore;            // narrow scratch [n_grad_blocks][n_layers-1][4][max_width][tile]
  float* tail_partials;     // narrow scratch [n_tail_blocks]
  const Member* members;    // narrow: one entry a member, or null (a solo call: the scalars)
  int* cursor;              // K9: the epoch's row of sched, metrics and new_colloc, or null
  const uint4* sched;       // K9: a row an epoch: epoch_lo, epoch_hi, bc1 and bc2 (float32 bits)
  long long metrics_stride;     // K9: floats from one row of metrics to the next
  long long new_colloc_stride;  // K9: floats from one row of new_colloc to the next
  float lb0, lb1, ub0, ub1, lam1, lam2, rho, lr;
  float one_minus_b1, b1, one_minus_b2, b2, eps, bc1, bc2, threshold;
  int n_u, n_f, kind, explicit_inner, tile, tail_tile, nb_f, nb_u, nb_tail;
  unsigned seed_lo, seed_hi, epoch_lo, epoch_hi;
};

// -- the narrow design --------------------------------------------------------

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

template <typename T>
__device__ __forceinline__ T* member_ptr(T* p, int m, long long per_member) {
  return p == nullptr ? p : p + static_cast<long long>(m) * per_member;
}

// K9: with a cursor, the epoch's words from row *cursor of the schedule in
// place of the by-value ones, and the epoch's rows of metrics and of the
// given points; with none, the call as it is.
__device__ __forceinline__ Step at_cursor(Step st) {
  if (st.cursor == nullptr) return st;
  const int row = *st.cursor;
  const uint4 w = st.sched[row];
  st.epoch_lo = w.x;
  st.epoch_hi = w.y;
  st.bc1 = __uint_as_float(w.z);
  st.bc2 = __uint_as_float(w.w);
  st.metrics += row * st.metrics_stride;
  if (st.new_colloc != nullptr) st.new_colloc += row * st.new_colloc_stride;
  return st;
}

// Member m's view of a narrow call: each per-member buffer offset by m times
// its size (64-bit), the seed, rho and threshold from members[m] when the
// call has a member table. The shared inputs (x_data, u_data) stay.
__device__ __forceinline__ Step member_step(const Net& net, Step st, int m) {
  const long long P = net.n_params, F = st.n_f;
  const long long nb = st.nb_f + st.nb_u;
  st.params = member_ptr(st.params, m, P);
  st.mu = member_ptr(st.mu, m, P);
  st.nu = member_ptr(st.nu, m, P);
  st.colloc = member_ptr(st.colloc, m, 2 * F);
  st.z = member_ptr(st.z, m, F);
  st.dual = member_ptr(st.dual, m, F);
  st.new_colloc = member_ptr(st.new_colloc, m, 2 * F);
  st.params_out = member_ptr(st.params_out, m, P);
  st.mu_out = member_ptr(st.mu_out, m, P);
  st.nu_out = member_ptr(st.nu_out, m, P);
  st.colloc_out = member_ptr(st.colloc_out, m, 2 * F);
  st.z_out = member_ptr(st.z_out, m, F);
  st.dual_out = member_ptr(st.dual_out, m, F);
  st.metrics = member_ptr(st.metrics, m, 7);
  st.grad_out = member_ptr(st.grad_out, m, P);
  st.partials = member_ptr(st.partials, m, nb * (P + 1));
  st.pstore = member_ptr(st.pstore, m,
                         nb * (net.n_layers - 1) * 4 * net.max_width * st.tile);
  st.tail_partials = member_ptr(st.tail_partials, m, st.nb_tail);
  if (st.members != nullptr) {
    const Member mb = st.members[m];
    st.seed_lo = mb.seed_lo;
    st.seed_hi = mb.seed_hi;
    st.rho = mb.rho;
    st.threshold = mb.threshold;
  }
  return st;
}

__global__ void __launch_bounds__(kThreads)
grad_kernel(Net net, Step call) {
  const Step st = member_step(net, call, blockIdx.y);
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
__global__ void adam_kernel(Net net, Step call) {
  const Step st = member_step(net, at_cursor(call), blockIdx.y);
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
tail_kernel(Net net, Step call) {
  const Step st = member_step(net, at_cursor(call), blockIdx.y);
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

// One block, a thread a member: the misfit from the tail's partials, then
// (K9) the cursor on to the next epoch once every thread has read it.
__global__ void finalize_kernel(Net net, Step call, int n_members) {
  const Step at = at_cursor(call);
  for (int m = threadIdx.x; m < n_members; m += blockDim.x) {
    const Step st = member_step(net, at, m);
    float mis = 0.0f;
    if (st.kind == kAdmm) {
      for (int b = 0; b < st.nb_tail; ++b) mis += st.tail_partials[b];
      mis /= static_cast<float>(st.n_f);
    }
    st.metrics[kMetricMisfit] = mis;
  }
  if (call.cursor == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) *call.cursor += 1;
}

size_t grad_smem(int max_width, int tile) {
  return sizeof(float) * (12u * static_cast<size_t>(max_width) * (tile + 4) + tile);
}

size_t tail_smem(int max_width, int tile) {
  return sizeof(float) * (8u * static_cast<size_t>(max_width) * (tile + 4) + tile);
}

// Raise, never lower, a kernel's dynamic shared memory limit: a captured
// graph (K9) keeps the size its launches were captured with.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || static_cast<size_t>(a.maxDynamicSharedSizeBytes) >= bytes) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One epoch of `n_members` members (K8; 1 and no member table: K3's solo
// epoch), each launch with the member as blockIdx.y. `launch_only` (K9's
// capture) leaves out the kernels' set-up, which an earlier call made.
int narrow_epoch(const Net& net, Step st, int n_members, bool launch_only, cudaStream_t s) {
  const int tile = st.tile, tail_tile = st.tail_tile;
  if (tile < kR || tile % kR || tail_tile < kR || tail_tile % kR || n_members < 1 ||
      n_members > 65535 || (n_members > 1 && st.members == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  st.nb_f = (st.n_f + tile - 1) / tile;
  st.nb_u = (st.n_u + tile - 1) / tile;
  st.nb_tail = (st.n_f + tail_tile - 1) / tail_tile;
  const size_t gsm = grad_smem(net.max_width, tile);
  const size_t tsm = tail_smem(net.max_width, tail_tile);
  if (!launch_only) {
    PINNS_CHECK(allow_smem(grad_kernel, gsm));
    PINNS_CHECK(allow_smem(tail_kernel, tsm));
  }
  const unsigned E = static_cast<unsigned>(n_members);
  grad_kernel<<<dim3(st.nb_f + st.nb_u, E), kThreads, gsm, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  adam_kernel<<<dim3((net.n_params + 255) / 256, E), 256, 0, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  tail_kernel<<<dim3(st.nb_tail, E), kThreads, tsm, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  finalize_kernel<<<1, 32, 0, s>>>(net, st, n_members);
  return static_cast<int>(cudaGetLastError());
}

// -- the wide design ----------------------------------------------------------

// The products' block tile: 32 x 32 of 64 threads with 4 x 4 register
// tiles, so that a product over the presets' 1,100 points takes 1,008 blocks
// (K2's 128 x 128 tile would give it 72). The engine's loader copies one
// 16-byte vector a thread, so its tiles are square with 2 x threads rows: a
// 64 x 64 tile would need 128 threads in 4 warps, which neither register
// tile lays out.
struct Tile : TileCfg<64, 4, 4, 1, 8> {};

// The stacked rows of a call: points [0, nf_pad) are the collocation
// segment, [nf_pad, n_pad) the data segment (empty in the tail), both whole
// kPts-point tiles; a segment holds its four streams one after another, so
// stream s of a point is one row of a (4 n_pad x width) matrix.
struct Rows {
  int nf_pad, n_pad;
  __device__ __forceinline__ long long row(int p, int s) const {
    return p < nf_pad
               ? static_cast<long long>(s) * nf_pad + p
               : 4LL * nf_pad + static_cast<long long>(s) * (n_pad - nf_pad) + (p - nf_pad);
  }
};

// H_0's four rows of point p (ld_h(2) = 4 floats each): normalized (x, t),
// the indicator 1 on the value row and a zero; the constant tangents
// (2/(ub0-lb0), 0), (0, 2/(ub1-lb1)); the second-derivative stream is zero.
__device__ __forceinline__ void store_input(float4* __restrict__ H, const Rows& rw, int p,
                                            float xv, float tv, const Step& st) {
  const float rx = st.ub0 - st.lb0, rt = st.ub1 - st.lb1;
  H[rw.row(p, 0)] = make_float4(2.0f * (xv - st.lb0) / rx - 1.0f,
                                2.0f * (tv - st.lb1) / rt - 1.0f, 1.0f, 0.0f);
  H[rw.row(p, 1)] = make_float4(2.0f / rx, 0.0f, 0.0f, 0.0f);
  H[rw.row(p, 2)] = make_float4(0.0f, 2.0f / rt, 0.0f, 0.0f);
  H[rw.row(p, 3)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// H_0 of the stacked batch: collocation points from `colloc`, data points
// from st.x_data; padded points at (0, 0).
__global__ void input_kernel(Step st, const float* __restrict__ colloc, Rows rw,
                             float4* __restrict__ H) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < rw.n_pad;
       p += gridDim.x * blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p < rw.nf_pad) {
      if (p < st.n_f) {
        xv = colloc[2 * p];
        tv = colloc[2 * p + 1];
      }
    } else if (p - rw.nf_pad < st.n_u) {
      xv = st.x_data[2 * (p - rw.nf_pad)];
      tv = st.x_data[2 * (p - rw.nf_pad) + 1];
    }
    store_input(H, rw, p, xv, tv, st);
  }
}

// The new batch: Philox-4x32-10 in the words and order of tail_kernel (or
// the given points) into colloc_out, and its H_0 (one segment of nf_pad
// points) for the tail's forward.
__global__ void draw_kernel(Step call, int nf_pad, float4* __restrict__ H) {
  const Step st = at_cursor(call);
  const Rows rw{nf_pad, nf_pad};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nf_pad; i += gridDim.x * blockDim.x) {
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
    store_input(H, rw, i, xv, tv, st);
  }
}

// The tanh Taylor rule at one point and unit: the factors s, s', s'' and the
// output streams from the pre-activation streams.
__device__ __forceinline__ void activate(float p, float px, float pt, float pxx, float& s,
                                         float& d1, float& d2, float& h, float& hx, float& ht,
                                         float& hxx) {
  s = tanhf(p);
  d1 = 1.0f - s * s;
  d2 = -2.0f * s * d1;
  h = s;
  hx = d1 * px;
  ht = d1 * pt;
  hxx = d2 * px * px + d1 * pxx;
}

// Hidden layer l of a forward: P (4 n_pad x d) holds the product's dot (+ bias
// on value rows); H receives the layer's output streams (4 n_pad x ld_h(d):
// column d the indicator, the rest of the row unused). Blocks of 32 x kPts
// threads, one a (group of 32 units, tile of kPts points), a thread a
// (unit, point).
__global__ void forward_act_kernel(const float* __restrict__ P, Rows rw, int d,
                                   float* __restrict__ H) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int p = blockIdx.y * kPts + threadIdx.y;
  const int ld = ld_h(d);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) H[rw.row(p, s) * ld + d] = s == 0 ? 1.0f : 0.0f;
  }
  if (j >= d) return;
  const float a = P[rw.row(p, 0) * d + j], ax = P[rw.row(p, 1) * d + j];
  const float at = P[rw.row(p, 2) * d + j], axx = P[rw.row(p, 3) * d + j];
  float s, d1, d2, h, hx, ht, hxx;
  activate(a, ax, at, axx, s, d1, d2, h, hx, ht, hxx);
  H[rw.row(p, 0) * ld + j] = h;
  H[rw.row(p, 1) * ld + j] = hx;
  H[rw.row(p, 2) * ld + j] = ht;
  H[rw.row(p, 3) * ld + j] = hxx;
}

// The sum of one double a thread over a block of kPts threads, in a fixed
// tree; thread 0 gets it.
__device__ __forceinline__ double block_tree_sum(double v, double* __restrict__ sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kPts / 2; w >= 1; w /= 2) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  return sh[0];
}

// The head and the seeds, one thread a point of a kPts-point tile: (u, u_x,
// u_t, u_xx) from the head's product, the residual and dL/df of a
// collocation point (the narrow grad_kernel's arithmetic), 2 (u - u_data) /
// N_u on a data point's value row, zero elsewhere. G (4 n_pad x 1) receives
// the seeds; db (tiles) the tile's sum of the value seeds (the head's db),
// loss_part (tiles) the tile's sum of the loss terms, both in double.
__global__ void __launch_bounds__(kPts)
seed_kernel(const float* __restrict__ head, Step st, Rows rw, float* __restrict__ G,
            double* __restrict__ db, double* __restrict__ loss_part) {
  __shared__ double red_g[kPts], red_v[kPts];
  const int p = blockIdx.x * kPts + threadIdx.x;
  const float u = head[rw.row(p, 0)], ux = head[rw.row(p, 1)];
  const float ut = head[rw.row(p, 2)], uxx = head[rw.row(p, 3)];
  float gu = 0.0f, gux = 0.0f, gut = 0.0f, guxx = 0.0f, val = 0.0f;
  if (p < rw.nf_pad) {
    const int i = p;
    if (i < st.n_f) {
      const float f = ut + st.lam1 * u * ux - st.lam2 * uxx;
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
      gu = gf * st.lam1 * ux;
      gux = gf * st.lam1 * u;
      gut = gf;
      guxx = -st.lam2 * gf;
    }
  } else if (p - rw.nf_pad < st.n_u) {
    const float d = u - st.u_data[p - rw.nf_pad];
    gu = 2.0f * d / static_cast<float>(st.n_u);
    val = d * d;
  }
  G[rw.row(p, 0)] = gu;
  G[rw.row(p, 1)] = gux;
  G[rw.row(p, 2)] = gut;
  G[rw.row(p, 3)] = guxx;
  const double sg = block_tree_sum(gu, red_g);
  const double sv = block_tree_sum(val, red_v);
  if (threadIdx.x == 0) {
    db[blockIdx.x] = sg;
    loss_part[blockIdx.x] = sv;
  }
}

// Backward through the tanh of hidden layer l: G (4 n_pad x d) holds gH, the
// adjoints of the layer's output streams, and receives those of its
// pre-activation streams P (4 n_pad x d, as the forward stored them); sums
// (tiles x d) receives the per-tile sums of the value adjoints, in double:
// db_l. Unless null, H receives the output streams of layer l - 1,
// recomputed from its pre-activations Pb (4 n_pad x db_w; H 4 n_pad x
// ld_h(db_w)): the input of the product dW_l that the next launch pairs with
// gH of layer l. (K2's pass, on K3's stacked rows, a thread a (unit,
// point) as forward_act_kernel.)
__global__ void backward_act_kernel(const float* __restrict__ P, float* __restrict__ G, Rows rw,
                                    int d, double* __restrict__ sums,
                                    const float* __restrict__ Pb, int db_w,
                                    float* __restrict__ H) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int p = blockIdx.y * kPts + threadIdx.y;
  double db = 0.0;
  if (j < d) {
    const long long a0 = rw.row(p, 0) * d + j, a1 = rw.row(p, 1) * d + j;
    const long long a2 = rw.row(p, 2) * d + j, a3 = rw.row(p, 3) * d + j;
    const float pv = P[a0], px = P[a1], pt = P[a2], pxx = P[a3];
    float s, d1, d2, h, hx, ht, hxx;
    activate(pv, px, pt, pxx, s, d1, d2, h, hx, ht, hxx);
    const float gh = G[a0], ghx = G[a1], ght = G[a2], ghxx = G[a3];
    const float gp = d1 * (gh - 2.0f * s * (ghx * px + ght * pt + ghxx * pxx) +
                           (6.0f * s * s - 2.0f) * ghxx * px * px);
    G[a3] = ghxx * d1;
    G[a1] = ghx * d1 + 2.0f * ghxx * d2 * px;
    G[a2] = ght * d1;
    G[a0] = gp;
    db = gp;
  }
  tile_column_sum(db, j, d, sums);
  if (H == nullptr) return;
  const int ld = ld_h(db_w);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) H[rw.row(p, s) * ld + db_w] = s == 0 ? 1.0f : 0.0f;
  }
  for (int c = j; c < db_w; c += gridDim.x * 32) {
    float s, d1, d2, h, hx, ht, hxx;
    activate(Pb[rw.row(p, 0) * db_w + c], Pb[rw.row(p, 1) * db_w + c],
             Pb[rw.row(p, 2) * db_w + c], Pb[rw.row(p, 3) * db_w + c], s, d1, d2, h, hx, ht,
             hxx);
    H[rw.row(p, 0) * ld + c] = h;
    H[rw.row(p, 1) * ld + c] = hx;
    H[rw.row(p, 2) * ld + c] = ht;
    H[rw.row(p, 3) * ld + c] = hxx;
  }
}

// sum over splits z0 <= z < z1 of partials[z][i], in double: four chains
// (z mod 4), so that four loads are in flight, joined in a fixed order.
__device__ __forceinline__ double sum_splits(const float* __restrict__ partials, int z0, int z1,
                                             int n_params, int i) {
  double u[4] = {0.0, 0.0, 0.0, 0.0};
  int z = z0;
  for (; z + 4 <= z1; z += 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] += partials[static_cast<long long>(z + c) * n_params + i];
  }
  for (; z < z1; ++z) u[0] += partials[static_cast<long long>(z) * n_params + i];
  return (u[0] + u[1]) + (u[2] + u[3]);
}

// Where the wide launcher put the reductions' inputs: dW's splits (the first
// splits_f over collocation rows), db's per-tile sums of every layer (layer
// l at sums + l tiles max_width, tiles x dims[l + 1]; the first tiles_f
// tiles collocation points) and the loss's per-tile sums.
struct Reduce {
  const float* partials;
  const double* sums;
  const double* loss_part;
  float* grad;
  int splits, splits_f, tiles, tiles_f;
};

// One thread per parameter: its gradient from the collocation sums (scaled
// by S = sum |f| for 'l1_sq_norm') and the data sums, rounded once, then
// Adam as the narrow adam_kernel; thread 0 writes the loss metrics.
__global__ void wide_adam_kernel(Net net, Step call, Reduce rd) {
  const Step st = at_cursor(call);
  double S = 0.0, D = 0.0;
  for (int c = 0; c < rd.tiles_f; ++c) S += rd.loss_part[c];
  for (int c = rd.tiles_f; c < rd.tiles; ++c) D += rd.loss_part[c];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    const float n_f = static_cast<float>(st.n_f);
    const float Sf = static_cast<float>(S);
    const float data_term = static_cast<float>(D) / static_cast<float>(st.n_u);
    float res_term = Sf;  // admm: sum of the per-point penalties
    if (st.kind == kMeanSq || st.kind == kL2Sq) res_term = Sf / n_f;
    if (st.kind == kL1Sq) res_term = Sf * Sf / n_f;
    st.metrics[kMetricData] = data_term;
    st.metrics[kMetricRes] = res_term;
    st.metrics[kMetricLoss] = data_term + res_term;
    st.metrics[kMetricLam1] = st.lam1;
    st.metrics[kMetricLam2] = st.lam2;
    st.metrics[kMetricLbfgs] = 0.0f;
  }
  if (i >= net.n_params) return;
  double res = 0.0, dat = 0.0;
  bool bias = false;
  for (int l = 0; l < net.n_layers && !bias; ++l) {
    const int j = i - net.b_off[l], d = net.dims[l + 1];
    if (j >= 0 && j < d) {
      const double* __restrict__ s =
          rd.sums + static_cast<long long>(l) * rd.tiles * net.max_width;
      for (int c = 0; c < rd.tiles_f; ++c) res += s[static_cast<long long>(c) * d + j];
      for (int c = rd.tiles_f; c < rd.tiles; ++c) dat += s[static_cast<long long>(c) * d + j];
      bias = true;
    }
  }
  if (!bias) {
    res = sum_splits(rd.partials, 0, rd.splits_f, net.n_params, i);
    dat = sum_splits(rd.partials, rd.splits_f, rd.splits, net.n_params, i);
  }
  const float g = static_cast<float>(st.kind == kL1Sq ? S * res + dat : res + dat);
  rd.grad[i] = g;
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

// z/dual at the new points (one segment of nf_pad points; the narrow
// tail_kernel's arithmetic) from the head's product with the new params,
// one thread a point; tail_part (tiles) the tile's sum of |f - z| in double.
__global__ void __launch_bounds__(kPts)
tail_head_kernel(const float* __restrict__ head, Step st, int nf_pad,
                 double* __restrict__ tail_part) {
  __shared__ double red[kPts];
  const int i = blockIdx.x * kPts + threadIdx.x;
  float val = 0.0f;
  if (i < st.n_f) {
    const float u = head[i], ux = head[nf_pad + i];
    const float ut = head[2 * nf_pad + i], uxx = head[3 * nf_pad + i];
    const float f = ut + st.lam1 * u * ux - st.lam2 * uxx;
    const float dual = st.dual[i];
    const float v = __fadd_rn(f, __fdiv_rn(dual, st.rho));
    const float mag = fmaxf(__fsub_rn(fabsf(v), st.threshold), 0.0f);
    const float z = static_cast<float>((v > 0.0f) - (v < 0.0f)) * mag;
    st.z_out[i] = z;
    st.dual_out[i] = __fadd_rn(dual, __fmul_rn(st.rho, __fsub_rn(f, z)));
    val = fabsf(__fsub_rn(f, z));
  }
  const double sum = block_tree_sum(val, red);
  if (threadIdx.x == 0) tail_part[blockIdx.x] = sum;
}

// The misfit from the tail's per-tile sums, then (K9) the cursor on to the
// next epoch.
__global__ void wide_finalize_kernel(Step call, const double* __restrict__ tail_part, int tiles) {
  if (threadIdx.x != 0) return;
  const Step st = at_cursor(call);
  float mis = 0.0f;
  if (st.kind == kAdmm) {
    double sum = 0.0;
    for (int c = 0; c < tiles; ++c) sum += tail_part[c];
    mis = static_cast<float>(sum) / static_cast<float>(st.n_f);
  }
  st.metrics[kMetricMisfit] = mis;
  if (call.cursor != nullptr) *call.cursor += 1;
}

// The wide plan (ops/kernels/fused_step.py::step_plan): the segments'
// padding, the products' block tile, dW's split.
struct WidePlan {
  int nf_pad, nu_pad, tile, split_rows, splits;
};

// The hidden layers of a forward over `rows` stacked rows from H_0 = h0:
// P_l = H_l [W_l; b_l] into p_out[l], then H_l+1 into hbuf; returns the input
// of the head (hbuf, or h0 for a net without hidden layers).
cudaError_t hidden_forward_products(const Net& net, const float* params, const float* h0,
                                    Rows rw, float* const* p_out, float* hbuf, cudaStream_t s) {
  const int rows = 4 * rw.n_pad, tiles = rw.n_pad / kPts;
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* W = params + net.w_off[l];
    const Gemm g{l == 0 ? h0 : hbuf, W, W, p_out[l], ld_h(din), dout, dout, rows, dout, din + 1,
                 din + 1, 0, 1, 0};
    cudaError_t e = gemm<Tile, false, false>(g, 1, s);
    if (e != cudaSuccess) return e;
    forward_act_kernel<<<dim3((dout + 31) / 32, tiles), dim3(32, kPts), 0, s>>>(p_out[l], rw,
                                                                                  dout, hbuf);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The head's product (a width-1 output) over the stacked rows.
cudaError_t head_product(const Net& net, const float* params, const float* in, int rows,
                         float* out, cudaStream_t s) {
  const int l = net.n_layers - 1, din = net.dims[l];
  const float* W = params + net.w_off[l];
  const Gemm g{in, W, W, out, ld_h(din), 1, 1, rows, 1, din + 1, din + 1, 0, 1, 0};
  return gemm<Tile, false, false>(g, 1, s);
}

// One wide epoch on `s`; `scratch` (scratch_floats floats) holds, in this
// order and each part on 16 bytes: sums, n_layers x tiles x max_width
// doubles (tiles = n_pad / kPts); loss_part, tiles doubles; tail_part,
// nf_pad / kPts doubles; h0, 4 n_pad x 4; pstore, the pre-activations of every
// hidden layer (4 n_pad x dims[l + 1] each, in layer order); hbuf, 4 n_pad x
// ld_h(max_width); gbuf, 2 x 4 n_pad x max_width; head, 4 n_pad; partials,
// splits x n_params; grad, n_params. The tail reuses h0, gbuf (its P), hbuf
// and head.
int wide_epoch(const Net& net, const Step& st, const WidePlan& wp, float* scratch,
               long long scratch_floats, cudaStream_t s) {
  const int L = net.n_layers;
  const Rows rw{wp.nf_pad, wp.nf_pad + wp.nu_pad};
  const long long rows = 4LL * rw.n_pad;
  const int tiles = rw.n_pad / kPts, tiles_f = wp.nf_pad / kPts;
  long long p_off[kMaxLayers];
  long long p_end = 0;
  for (int l = 0; l + 1 < L; ++l) {
    p_off[l] = p_end;
    p_end += rows * net.dims[l + 1];
  }
  const long long sums_stride = static_cast<long long>(tiles) * net.max_width;
  Carve c{scratch, 0};
  double* sums = reinterpret_cast<double*>(c.take(2 * L * sums_stride));
  double* loss_part = reinterpret_cast<double*>(c.take(2LL * tiles));
  double* tail_part = reinterpret_cast<double*>(c.take(2LL * tiles_f));
  float* h0 = c.take(rows * 4);
  float* pstore = c.take(p_end);
  float* hbuf = c.take(rows * ld_h(net.max_width));
  float* gbuf = c.take(2 * rows * net.max_width);
  float* head = c.take(rows);
  float* partials = c.take(static_cast<long long>(wp.splits) * net.n_params);
  float* grad = c.take(net.n_params);
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  if (st.grad_out != nullptr) grad = st.grad_out;
  float* P[kMaxLayers];
  for (int l = 0; l + 1 < L; ++l) P[l] = pstore + p_off[l];

  // forward and head at the current batch
  input_kernel<<<ew_blocks(rw.n_pad), kEwThreads, 0, s>>>(st, st.colloc, rw,
                                                          reinterpret_cast<float4*>(h0));
  PINNS_CHECK(cudaGetLastError());
  PINNS_CHECK(hidden_forward_products(net, st.params, h0, rw, P, hbuf, s));
  PINNS_CHECK(head_product(net, st.params, L > 1 ? hbuf : h0, static_cast<int>(rows), head, s));
  float* G = gbuf;
  float* Gn = gbuf + rows * net.max_width;
  seed_kernel<<<tiles, kPts, 0, s>>>(head, st, rw, G, sums + (L - 1) * sums_stride, loss_part);
  PINNS_CHECK(cudaGetLastError());

  // backward, head first: G holds the adjoints of layer l's pre-activation
  // streams, hbuf H_l, the input streams of layer l
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const Gemm dw{l == 0 ? h0 : hbuf, G, G, partials + net.w_off[l], ld_h(din), dout, dout, din,
                  dout, static_cast<int>(rows), wp.split_rows, net.n_params, 1, 0};
    const int dw_bx = (din + Tile::kBM - 1) / Tile::kBM;
    const int dw_by = (dout + Tile::kBN - 1) / Tile::kBN;
    if (l == 0) {
      PINNS_CHECK((gemm<Tile, true, false>(dw, wp.splits, s)));
      break;
    }
    const float* W = st.params + net.w_off[l];
    const Gemm gh{G, W, W, Gn, dout, dout, din, static_cast<int>(rows), din, dout, dout, 0, 1, 0};
    const int gh_bx = static_cast<int>((rows + Tile::kBM - 1) / Tile::kBM);
    const int gh_by = (din + Tile::kBN - 1) / Tile::kBN;
    const int pair_blocks = dw_bx * dw_by * wp.splits + gh_bx * gh_by;
    gemm_pair_kernel<Tile, false><<<pair_blocks, Tile::kThreads, 0, s>>>(dw, dw_bx, dw_by,
                                                                         wp.splits, gh, gh_bx,
                                                                         gh_by);
    PINNS_CHECK(cudaGetLastError());
    const int below = net.dims[l - 1];
    backward_act_kernel<<<dim3(((din > below ? din : below) + 31) / 32, tiles), dim3(32, kPts),
                          0, s>>>(P[l - 1], Gn, rw, din, sums + (l - 1) * sums_stride,
                                  l >= 2 ? P[l - 2] : nullptr, below, l >= 2 ? hbuf : nullptr);
    PINNS_CHECK(cudaGetLastError());
    float* t = G;
    G = Gn;
    Gn = t;
  }

  // Adam on the reduced gradient
  const Reduce rd{partials, sums, loss_part, grad, wp.splits,
                  4 * wp.nf_pad / wp.split_rows, tiles, tiles_f};
  wide_adam_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(net, st, rd);
  PINNS_CHECK(cudaGetLastError());

  // the tail: the new batch, then (for 'admm') z/dual at it with the new params
  const Rows rt{wp.nf_pad, wp.nf_pad};
  draw_kernel<<<ew_blocks(wp.nf_pad), kEwThreads, 0, s>>>(st, wp.nf_pad,
                                                          reinterpret_cast<float4*>(h0));
  PINNS_CHECK(cudaGetLastError());
  if (st.kind == kAdmm) {
    float* tail_p[kMaxLayers];
    for (int l = 0; l + 1 < L; ++l) tail_p[l] = gbuf;
    PINNS_CHECK(hidden_forward_products(net, st.params_out, h0, rt, tail_p, hbuf, s));
    PINNS_CHECK(head_product(net, st.params_out, L > 1 ? hbuf : h0, 4 * wp.nf_pad, head, s));
    tail_head_kernel<<<tiles_f, kPts, 0, s>>>(head, st, wp.nf_pad, tail_part);
    PINNS_CHECK(cudaGetLastError());
  }
  wide_finalize_kernel<<<1, 32, 0, s>>>(st, tail_part, tiles_f);
  return static_cast<int>(cudaGetLastError());
}

// The checks of a wide plan: whole kPts-point tiles in each segment, the tile
// the file instantiates, dW's split in whole depth steps that covers the
// rows exactly and never straddles the two segments, an aligned scratch,
// operands that 32-bit offsets reach, grids the card launches.
bool wide_plan_ok(const Net& net, const Step& st, const WidePlan& wp, const float* scratch) {
  const long long n_pad = static_cast<long long>(wp.nf_pad) + wp.nu_pad, rows = 4 * n_pad;
  return wp.nf_pad >= st.n_f && wp.nf_pad % kPts == 0 && wp.nu_pad >= st.n_u &&
         wp.nu_pad % kPts == 0 && n_pad / kPts <= 65535 &&
         wp.tile == Tile::kBM && wp.split_rows >= kDepth &&
         wp.split_rows % kDepth == 0 && (4LL * wp.nf_pad) % wp.split_rows == 0 &&
         wp.splits >= 1 && wp.splits <= 65535 &&
         static_cast<long long>(wp.splits) * wp.split_rows >= rows &&
         static_cast<long long>(wp.splits - 1) * wp.split_rows < rows &&
         (reinterpret_cast<size_t>(scratch) & 15) == 0 &&
         rows * ld_h(net.max_width) <= 0x7fffffffLL &&
         static_cast<long long>(wp.splits) * net.n_params <= 0x7fffffffLL;
}

}  // namespace k3

using namespace k3;

}  // namespace

// Indices of the pointer, float and int argument arrays
// (ops/kernels/fused_step.py builds them in this order).
enum PtrArg {
  kParams, kMu, kNu, kXData, kUData, kColloc, kZ, kDual, kNewColloc,
  kParamsOut, kMuOut, kNuOut, kCollocOut, kZOut, kDualOut, kMetrics, kGradOut,
  kPartials, kPstore, kTailPartials, kScratch, kMembers, kCursor, kSched, kNumPtrs
};
enum FloatArg {
  kLb0, kLb1, kUb0, kUb1, kLam1, kLam2, kRho, kLr, kOneMinusB1, kB1, kOneMinusB2,
  kB2, kEps, kBc1, kBc2, kThreshold, kNumFloats
};
enum IntArg {
  kNU, kNF, kKind, kExplicit, kPlanTile, kTailTile, kSeed, kEpoch, kDevice, kNfPad, kNuPad,
  kSplitRows, kSplits, kScratchFloats, kNMembers, kMetricsStride, kNewCollocStride,
  kLaunchOnly, kNumInts
};

extern "C" int pinns_fused_step_sizes(int* n_ptrs, int* n_floats, int* n_ints) {
  *n_ptrs = kNumPtrs;
  *n_floats = kNumFloats;
  *n_ints = kNumInts;
  return 0;
}

// One epoch on `stream`. `dims` (host) holds n_layers + 1 widths; the other
// arrays follow the enums above. All device buffers are float32, contiguous,
// on device `ints[kDevice]`; the wrapper validated their shapes. A net whose
// widths are all at most 32 takes the narrow design (kPlanTile the grad
// kernel's tile, kTailTile, and the partials, pstore and tail_partials
// scratch), for kNMembers members (K8: every per-member buffer stacked
// member after member, kMembers their device table; 1 and a null table: a
// solo epoch, whose seed, rho and threshold are the scalars); any other the
// wide design (kPlanTile the products' block tile, the plan's other ints and
// `scratch`; one member, no table), which refuses a plan that does not fit
// its layout with cudaErrorInvalidValue. K9: a non-null kCursor (an int on
// the device) makes every launch read the epoch's words from row *cursor of
// kSched (4 words a row) and take its rows of metrics and new_colloc
// (kMetricsStride, kNewCollocStride floats apart), the epoch's last launch
// advancing the cursor; kEpoch and kBc1/kBc2 are then unused. kLaunchOnly
// issues the launches alone (no cudaSetDevice, no kernel attributes: what a
// stream capture takes), after an earlier call on this device made the
// set-up. Returns the CUDA error code of the first launch that failed (0 on
// success).
extern "C" int pinns_fused_step(const int* dims, int n_layers, const long long* ptrs,
                                const float* floats, const long long* ints, void* stream) {
  Net net;
  if (n_layers < 2 || !make_net(dims, n_layers, &net) || dims[n_layers] != 1 ||
      ints[kNU] < 1 || ints[kNF] < 1 || ints[kKind] < 0 || ints[kKind] > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  st.members = reinterpret_cast<const Member*>(ptrs[kMembers]);
  st.cursor = reinterpret_cast<int*>(ptrs[kCursor]);
  st.sched = reinterpret_cast<const uint4*>(ptrs[kSched]);
  st.metrics_stride = ints[kMetricsStride];
  st.new_colloc_stride = ints[kNewCollocStride];
  if (st.cursor != nullptr && (st.sched == nullptr || (ptrs[kSched] & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  st.tile = static_cast<int>(ints[kPlanTile]);
  st.tail_tile = static_cast<int>(ints[kTailTile]);
  st.nb_f = st.nb_u = st.nb_tail = 0;
  const unsigned long long seed = static_cast<unsigned long long>(ints[kSeed]);
  const unsigned long long epoch = static_cast<unsigned long long>(ints[kEpoch]);
  st.seed_lo = static_cast<unsigned>(seed & 0xFFFFFFFFull);
  st.seed_hi = static_cast<unsigned>(seed >> 32);
  st.epoch_lo = static_cast<unsigned>(epoch & 0xFFFFFFFFull);
  st.epoch_hi = static_cast<unsigned>(epoch >> 32);

  const bool launch_only = ints[kLaunchOnly] != 0;
  if (!launch_only) PINNS_CHECK(cudaSetDevice(static_cast<int>(ints[kDevice])));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_members = static_cast<int>(ints[kNMembers]);
  if (net.max_width <= kNarrowWidth) return narrow_epoch(net, st, n_members, launch_only, s);
  if (n_members != 1 || st.members != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan wp{static_cast<int>(ints[kNfPad]), static_cast<int>(ints[kNuPad]),
                    static_cast<int>(ints[kPlanTile]), static_cast<int>(ints[kSplitRows]),
                    static_cast<int>(ints[kSplits])};
  float* scratch = fp(kScratch);
  if (!wide_plan_ok(net, st, wp, scratch)) return static_cast<int>(cudaErrorInvalidValue);
  const long long scratch_floats = ints[kScratchFloats];
  return wide_epoch(net, st, wp, scratch, scratch_floats, s);
}

extern "C" const char* pinns_fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
