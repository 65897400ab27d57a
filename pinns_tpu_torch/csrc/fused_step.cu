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
// four launches, their blocks tiles of at most 8 points, so that a solo
// epoch spreads over the card's 132 SMs:
//   1 grad_kernel    one block per 8-point tile (collocation tiles, then
//                    data tiles; fewer points only where a block's shared
//                    memory would not hold the net: 18 or more layers of
//                    width 32): 138 blocks of 256 threads at N_f 1,000 and
//                    N_u 100. The params, and every layer's input streams H_l
//                    and pre-activation streams P_l, stay in the block's
//                    shared memory (65 KB at 8x20): nothing of the pass goes
//                    to device memory but the block's partial gradient and
//                    loss sum. A layer is one barrier-separated phase; every
//                    chain is short: a forward or gH item (two units of a
//                    point) one fmaf chain over the fan-in (fan-out) a
//                    stream and unit, a dW item (a 2 x 2 block of entries)
//                    four chains an entry over the tile's points, db one
//                    (18 phases at 8x20: 8 forward layers, the head and
//                    seeds, 9 backward layers).
//   2 adam_kernel    a block per 32 parameters, a warp per group of tile
//                    rows: the partials summed over the tiles in double
//                    (collocation and data tiles apart; each group in row
//                    order, the 8 groups joined in order), then Adam, a
//                    thread a parameter. Thread 0 writes the loss metrics.
//   3 tail_kernel    one block per 7-point tile of the new batch (143 at N_f
//                    1,000), a thread two units of a point (128 threads):
//                    Philox-4x32-10 draws the points (or takes given ones),
//                    the grad kernel's forward with the NEW params gives f,
//                    then z/dual and the tile's sum of |f - z|.
//   4 finalize_kernel  admm_misfit = mean |f - z| from the tiles' sums, a
//                    warp a member (double, a fixed shuffle tree).
// Each point's forward arithmetic (k ascending, fmaf from zero, the bias
// after, the tanh rule) and its gH are those of the 64-point tiles this
// design replaced, so at lr 0 the drawn points, z and dual of an epoch equal
// that design's bit for bit; the sums over points (dW, db, the loss, the
// misfit) run in the order above. What bounds it on the H100 at 8x20 and
// N_f = 1000: latency, not the operations (about 70 MFLOP in the grad
// kernel and 23 in the tail, 1.0 and 0.3 us at the fp32 peak): a block is a
// chain of layer phases, each a fan-in-long chain of dependent shared-memory
// loads and FMAs (PERF.md §5 and §6 have the device times).
//
// K8, the member-batched narrow design (replaces the vmapped step of
// pinns_tpu/parallel/ensemble.py:66-116, jax.vmap(step) over an ensemble's
// members): the same four launches with the member m as blockIdx.y (the
// finalize launch: one block, a warp a member). Member
// m's buffers (params, Adam moments, batch, z/dual, their outputs, its
// metrics row and its scratch) lie at m times their per-member size
// (member_step); its Philox seed, ADMM rho and prox threshold come from
// members[m]; the data, the coefficients, lr, the bias corrections and the
// epoch are shared. The tile plan does not depend on the member count, so
// each member's blocks do exactly the solo call's arithmetic in its order:
// member m of an E-member call equals a solo call of member m bit for bit (a
// solo call is member 0 of a call without a member table). At abgrall_admm's
// 8x20 a solo epoch runs 138 grad blocks, E members 138 E in one launch.
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
// The value-and-grad mode (kValueAndGrad; the narrow design, one member):
// the loss of the step's configuration and its gradient at the given params
// and the fixed batch, z, dual and rho, for K10's L-BFGS solve
// (csrc/lbfgs.cu). It launches the grad kernel and the Adam kernel, which
// sums the partials as an epoch does and writes the gradient to grad_out and
// the loss to loss_out, then returns before Adam: no tail, no metrics row.
// With a non-null `skip` both launches return at once while *skip != 0 (the
// solve's done flag), so that a captured solve step costs nothing after the
// end. The epoch path never sets either, so its arithmetic is unchanged.
//
// The post-update mode (pinns_fused_post_update; the narrow design, one
// member): what follows one of K10's L-BFGS outer solves
// (ops/kernels/lbfgs.py::LBFGSChunk), the tail kernel and the finalize kernel
// alone, with no grad or Adam launch. The tail reads the params from the
// solve's iterate (params_out: the net's part of K10's vec[X] row), takes the
// Philox epoch words from the chunk's schedule at the cursor (the points at
// the cursor's row of new_colloc when fed; a fixed batch gives its own points
// as new_colloc, with a row stride of 0), and writes the new batch, z and
// dual IN PLACE: colloc_out, z_out and dual_out are the solve's own colloc,
// z and dual, the buffers the captured solve reads. That aliasing is safe
// because no thread reads what another writes: a tail thread reads dual[i]
// before it writes dual_out[i] and z_out[i], for its own point i alone; it
// never reads z; it reads the old colloc only as a fixed batch's given
// point i, which it writes back unchanged; and the data tiles read only
// x_data, u_data and the params. The tail's grid has ceil(N_u / tail_tile)
// more blocks: the data points as forward-only tiles, each writing its sum
// of (u - u_data)^2 after the collocation tiles' sums. The finalize kernel
// sums those in double in its fixed order (data_term = D / N_u) and writes
// the cursor's metrics row: loss (the solve's f, sf[F_F], from f_in),
// data_term, res_term = f - data_term (JAX's res.f - data_weight * data_term;
// K10's scope has data_weight 1), lambda1, lambda2, admm_misfit (0 for
// another residual kind, which only draws or keeps its batch) and
// lbfgs_iters (si[I_K], from iters_in); then it advances the cursor. Seed,
// rho and the threshold come from a one-member table, so that one captured
// graph serves every seed and rho. The epoch path never sets post_update,
// so its arithmetic is unchanged.
//
// The Adam and tail arithmetic rounds after every operation (no contraction),
// as the plain PyTorch step does.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "layer_gemm.cuh"
#include "philox.cuh"

namespace {
namespace k3 {

constexpr int kThreads = 256;     // block size of the narrow grad and tail kernels
constexpr int kAdamCols = 32, kAdamGroups = 8;  // the narrow Adam kernel's block
constexpr int kTailThreads = 128;  // least block size of the narrow tail kernel
constexpr int kNarrowWidth = 32;  // ops/kernels/fused_step.py::NARROW_WIDTH
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on sm_90 (227 KB)
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
  float* loss_out;          // value_and_grad: the loss (1 float)
  const int* skip;          // value_and_grad: launches return while *skip != 0 (or null)
  const float* f_in;        // post_update: the solve's f (K10's sf[F_F])
  const int* iters_in;      // post_update: the solve's iterations (K10's si[I_K])
  float* partials;          // narrow scratch [n_grad_blocks][n_params + 1]
  float* tail_partials;     // narrow scratch [n_tail_blocks]
  const Member* members;    // narrow: one entry a member, or null (a solo call: the scalars)
  int* cursor;              // K9: the epoch's row of sched, metrics and new_colloc, or null
  const uint4* sched;       // K9: a row an epoch: epoch_lo, epoch_hi, bc1 and bc2 (float32 bits)
  long long metrics_stride;     // K9: floats from one row of metrics to the next
  long long new_colloc_stride;  // K9: floats from one row of new_colloc to the next
  float lb0, lb1, ub0, ub1, lam1, lam2, rho, lr;
  float one_minus_b1, b1, one_minus_b2, b2, eps, bc1, bc2, threshold;
  int n_u, n_f, kind, explicit_inner, tile, tail_tile, nb_f, nb_u, nb_tail;
  int nb_tail_data;         // post_update: the tail's data tiles, after its nb_tail
  int value_and_grad;       // K10: the grad kernel and the partials' sum only
  int post_update;          // K10's outer epoch: the tail and the finalize only
  unsigned seed_lo, seed_hi, epoch_lo, epoch_hi;
};

// -- the narrow design --------------------------------------------------------

// A narrow block's shared memory, in floats, each part on 16 bytes
// (ops/kernels/fused_step.py::narrow_smem): the params; `planes` planes of
// max_width x (tile + 1) float4, a layer's four streams (value, d/dx, d/dt,
// d2/dx2) of unit k at point p in element k (tile + 1) + p; the tile's loss
// terms. The one float4 of padding a unit puts the eight units that a
// quarter warp of dW items reads at one point on distinct banks. The grad
// kernel takes 2 n_layers + 1 planes (H_0 .. H_L-1, P_0 .. P_L-2, two
// adjoint planes), the tail kernel 2 (its layers' inputs in turn).
inline size_t narrow_smem(const Net& net, int tile, int planes) {
  return sizeof(float) * (static_cast<size_t>(net.n_params + 3) / 4 * 4 +
                          4u * static_cast<size_t>(net.max_width) * (tile + 1) * planes +
                          static_cast<size_t>(tile + 3) / 4 * 4);
}

// dst[0, n) = src[0, n) by the whole block, kStage loads a thread in flight
// before their stores.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  constexpr int kStage = 24;
  for (int base = threadIdx.x; base < n; base += kStage * blockDim.x) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      v[u] = i < n ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// A block holds a tile of at most kThreads / max_width points (its forward
// runs a thread for two units of a point, its backward loops over its items).
inline bool narrow_tile_ok(const Net& net, int tile) {
  return tile >= 1 && tile * net.max_width <= kThreads;
}

// The input streams of point slot p into H_0 (units x, t): normalized (x, t)
// and the constant tangents (2/(ub0-lb0), 0), (0, 2/(ub1-lb1)); the
// second-derivative stream is zero.
__device__ __forceinline__ void input_streams(float4* H, int ts, int p, float xv, float tv,
                                              const Step& st) {
  const float rx = st.ub0 - st.lb0, rt = st.ub1 - st.lb1;
  H[0 * ts + p] = make_float4(2.0f * (xv - st.lb0) / rx - 1.0f, 2.0f / rx, 0.0f, 0.0f);
  H[1 * ts + p] = make_float4(2.0f * (tv - st.lb1) / rt - 1.0f, 0.0f, 2.0f / rt, 0.0f);
}

// The tanh Taylor rule at one (unit, point): the output streams (s, s' px,
// s' pt, s'' px^2 + s' pxx) from the pre-activation streams a.
__device__ __forceinline__ float4 tanh_rule(float4 a) {
  const float t = tanhf(a.x);
  const float d1 = 1.0f - t * t;
  const float d2 = -2.0f * t * d1;
  const float hx = d1 * a.y;
  const float ht = d1 * a.z;
  const float hxx = d2 * a.y * a.y + d1 * a.w;
  return make_float4(t, hx, ht, hxx);
}

// Its adjoint: the adjoints of the pre-activation streams from g, those of
// the output streams, the pre-activation streams pv and s = tanh(pv.x).
__device__ __forceinline__ float4 tanh_adjoint(float4 g, float4 pv, float s) {
  const float gh = g.x, ghx = g.y, ght = g.z, ghxx = g.w;
  const float pxr = pv.y, ptr = pv.z, pxxr = pv.w;
  const float d1 = 1.0f - s * s, d2 = -2.0f * s * d1;
  const float o3 = ghxx * d1;
  const float o1 = ghx * d1 + 2.0f * ghxx * d2 * pxr;
  const float o2 = ght * d1;
  const float o0 = d1 * (gh - 2.0f * s * (ghx * pxr + ght * ptr + ghxx * pxxr) +
                         (6.0f * s * s - 2.0f) * ghxx * pxr * pxr);
  return make_float4(o0, o1, o2, o3);
}

// acc.s = fmaf(h.s, w, acc.s) for each stream s.
__device__ __forceinline__ void fma4(float4& acc, float4 h, float w) {
  acc.x = fmaf(h.x, w, acc.x);
  acc.y = fmaf(h.y, w, acc.y);
  acc.z = fmaf(h.z, w, acc.z);
  acc.w = fmaf(h.w, w, acc.w);
}

// acc.s = fmaf(h.s, g.s, acc.s) for each stream s.
__device__ __forceinline__ void mac4(float4& acc, float4 h, float4 g) {
  acc.x = fmaf(h.x, g.x, acc.x);
  acc.y = fmaf(h.y, g.y, acc.y);
  acc.z = fmaf(h.z, g.z, acc.z);
  acc.w = fmaf(h.w, g.w, acc.w);
}

// Taylor-2 forward of a tile through the hidden layers, from H_0 in the
// first plane of H, the params in `w` (shared memory). Thread e computes
// units jj and jj + ceil(dout / 2) (jj = e / T) at point e % T, so that one
// load of the point's input streams feeds both: each pre-activation stream
// one fmaf chain over the fan-in, k ascending from zero, the bias added
// after, then the tanh rule (each point's arithmetic as the 64-point design
// had it); a layer is one barrier-separated phase. kKeep (the grad kernel):
// layer l's output H_l+1 goes to plane l + 1 of H and its pre-activations
// P_l to plane l of P, both kept for the backward; otherwise the layers'
// inputs take H's first two planes in turn. Returns the last hidden layer's
// output.
template <bool kKeep>
__device__ const float4* tile_forward(const Net& net, const float* w, float4* H, float4* P,
                                      int T, int plane) {
  const int ts = T + 1, p = threadIdx.x % T, jj = threadIdx.x / T;
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1], half = (dout + 1) / 2;
    const float4* in = H + (kKeep ? l : (l & 1)) * plane;
    float4* out = H + (kKeep ? l + 1 : ((l + 1) & 1)) * plane;
    if (jj < half) {
      const float* W = w + net.w_off[l];
      const int j0 = jj, j1 = jj + half;
      const bool two = j1 < dout;
      const int j1c = two ? j1 : j0;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const float4 h = in[k * ts + p];
        fma4(a, h, W[k * dout + j0]);
        fma4(b, h, W[k * dout + j1c]);
      }
      a.x += w[net.b_off[l] + j0];
      b.x += w[net.b_off[l] + j1c];
      if (kKeep) P[l * plane + j0 * ts + p] = a;
      out[j0 * ts + p] = tanh_rule(a);
      if (two) {
        if (kKeep) P[l * plane + j1 * ts + p] = b;
        out[j1 * ts + p] = tanh_rule(b);
      }
    }
    __syncthreads();
  }
  return H + (kKeep ? net.n_layers - 1 : ((net.n_layers - 1) & 1)) * plane;
}

// The head (one output) at point p from the last hidden layer's output X:
// (u, u_x, u_t, u_xx).
__device__ __forceinline__ float4 tile_head(const Net& net, const float* w, const float4* X,
                                            int ts, int p) {
  const int l = net.n_layers - 1;
  const int din = net.dims[l];
  const float* W = w + net.w_off[l];
  float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int k = 0; k < din; ++k) fma4(y, X[k * ts + p], W[k]);
  y.x += w[net.b_off[l]];
  return y;
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

// One block a tile of st.tile points: the forward keeping every layer's
// input and pre-activation streams in shared memory, the head and the
// seeds, then the backward layer by layer. A backward layer is one phase of
// three kinds of item, gH first (the longest chains), in whole warps: gH =
// gP W^T through the tanh rule of the layer below, a thread two units of a
// point, one fmaf chain over the fan-out a stream and unit; dW, a thread a
// 2 x 2 block of entries, a chain over the tile's points a stream and entry
// (the four streams joined in a fixed order); db[j], a chain over the
// points. A thread's two units (entries) share its loads of the point's
// streams. The block writes its partial gradient and its partial loss sum
// (row blockIdx.x of the partials).
__global__ void __launch_bounds__(kThreads)
grad_kernel(Net net, Step call) {
  if (call.skip != nullptr && *call.skip != 0) return;
  const Step st = member_step(net, call, blockIdx.y);
  extern __shared__ float4 smem4[];
  const int T = st.tile, ts = T + 1, plane = net.max_width * ts, L = net.n_layers;
  float* w = reinterpret_cast<float*>(smem4);
  float4* H = smem4 + (net.n_params + 3) / 4;  // H_l, the input streams of layer l
  float4* P = H + L * plane;                    // P_l, the pre-activation streams of layer l
  float4* G = P + (L - 1) * plane;              // the adjoints of a layer's P
  float4* Gn = G + plane;                       // and of the layer's below
  float* red = reinterpret_cast<float*>(Gn + plane);
  const bool data_blk = blockIdx.x >= static_cast<unsigned>(st.nb_f);
  const int local = data_blk ? blockIdx.x - st.nb_f : blockIdx.x;
  const int n_pts = data_blk ? st.n_u : st.n_f;
  const float* pts = data_blk ? st.x_data : st.colloc;
  const int p0 = local * T;
  float* part = st.partials + static_cast<long long>(blockIdx.x) * (net.n_params + 1);

  // the point's coordinates and its seeds' inputs (u_data, or z and dual),
  // loaded beside the params so that their latencies overlap
  const int i = p0 + threadIdx.x;
  const bool mine = threadIdx.x < T && i < n_pts;
  float xv = 0.0f, tv = 0.0f, in_a = 0.0f, in_b = 0.0f;
  if (mine) {
    xv = pts[2 * i];
    tv = pts[2 * i + 1];
    if (data_blk) {
      in_a = st.u_data[i];
    } else if (st.kind == kAdmm) {
      in_a = st.z[i];
      in_b = st.dual[i];
    }
  }
  stage(w, st.params, net.n_params);
  if (threadIdx.x < T) input_streams(H, ts, threadIdx.x, xv, tv, st);
  __syncthreads();
  const float4* X = tile_forward<true>(net, w, H, P, T, plane);

  // Head and seeds: the adjoints of (u, u_x, u_t, u_xx), the head's G.
  if (threadIdx.x < T) {
    const int p = threadIdx.x;
    const float4 y = tile_head(net, w, X, ts, p);
    const float u = y.x, ux = y.y, ut = y.z, uxx = y.w;
    float gu = 0.0f, gux = 0.0f, gut = 0.0f, guxx = 0.0f, val = 0.0f;
    if (mine) {
      if (data_blk) {
        const float d = u - in_a;
        gu = 2.0f * d / static_cast<float>(st.n_u);
        val = d * d;
      } else {
        const float f = ut + st.lam1 * u * ux - st.lam2 * uxx;
        float gf;
        if (st.kind == kAdmm) {
          const float dual = in_b;
          const float q = f - in_a + dual / st.rho;
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
    }
    G[p] = make_float4(gu, gux, gut, guxx);
    red[p] = val;
  }
  __syncthreads();
  if (threadIdx.x == 0) part[net.n_params] = block_sum_ordered(red, T);

  // Backward, head first: H_l holds layer l's input streams, G the adjoints
  // of its pre-activation streams; Gn receives those of the layer below.
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const int hk = (din + 1) / 2, hj = (dout + 1) / 2;
    const float4* Hl = H + l * plane;
    const float* W = w + net.w_off[l];
    // gH's items fill whole warps, so that no warp runs two kinds of item
    const int n_gh = l > 0 ? hk * T : 0, gh_end = (n_gh + 31) / 32 * 32, n_dw = hk * hj;
    for (int item = threadIdx.x; item < gh_end + n_dw + dout; item += blockDim.x) {
      if (item < gh_end) {
        if (item >= n_gh) continue;
        // the adjoints of layer l's inputs k0 = kk and k1 = kk + hk at point
        // p (gH = gP W^T, one chain over j a stream), then through the tanh
        // of layer l-1 (s from H_l, its streams from P_l-1) to that layer's
        // pre-activations
        const int kk = item / T, p = item - kk * T;
        const int k0 = kk, k1 = kk + hk;
        const bool two = k1 < din;
        const int k1c = two ? k1 : k0;
        float4 g0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), g1 = g0;
#pragma unroll 4
        for (int j = 0; j < dout; ++j) {
          const float4 g = G[j * ts + p];
          fma4(g0, g, W[k0 * dout + j]);
          fma4(g1, g, W[k1c * dout + j]);
        }
        const float4* Pl = P + (l - 1) * plane;
        Gn[k0 * ts + p] = tanh_adjoint(g0, Pl[k0 * ts + p], Hl[k0 * ts + p].x);
        if (two) Gn[k1 * ts + p] = tanh_adjoint(g1, Pl[k1 * ts + p], Hl[k1 * ts + p].x);
      } else if (item < gh_end + n_dw) {
        // dW[k][j] = sum_p sum_s H_l[k][p].s G[j][p].s for k in (kk, kk + hk)
        // and j in (jj, jj + hj): a chain over the points a stream and an
        // entry, the four streams joined in a fixed order
        const int e = item - gh_end, kk = e / hj, jj = e - kk * hj;
        const int k1 = kk + hk, j1 = jj + hj;
        const int k1c = k1 < din ? k1 : kk, j1c = j1 < dout ? j1 : jj;
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 a00 = zero, a01 = zero, a10 = zero, a11 = zero;
#pragma unroll 4
        for (int p = 0; p < T; ++p) {
          const float4 h0 = Hl[kk * ts + p], h1 = Hl[k1c * ts + p];
          const float4 q0 = G[jj * ts + p], q1 = G[j1c * ts + p];
          mac4(a00, h0, q0);
          mac4(a01, h0, q1);
          mac4(a10, h1, q0);
          mac4(a11, h1, q1);
        }
        float* dW = part + net.w_off[l];
        dW[kk * dout + jj] = (a00.x + a00.y) + (a00.z + a00.w);
        if (j1 < dout) dW[kk * dout + j1] = (a01.x + a01.y) + (a01.z + a01.w);
        if (k1 < din) {
          dW[k1 * dout + jj] = (a10.x + a10.y) + (a10.z + a10.w);
          if (j1 < dout) dW[k1 * dout + j1] = (a11.x + a11.y) + (a11.z + a11.w);
        }
      } else {
        // db[j] = sum_p G[j][p].value
        const int j = item - gh_end - n_dw;
        float acc = 0.0f;
        for (int p = 0; p < T; ++p) acc += G[j * ts + p].x;
        part[net.b_off[l] + j] = acc;
      }
    }
    __syncthreads();
    float4* tmp = G;
    G = Gn;
    Gn = tmp;
  }
}

// One block a slice of kAdamCols parameters of a member, a warp a group of
// the tiles' partial rows (row b in group b mod kAdamGroups): each thread
// sums, in double and in row order, its column's rows of its group and the
// loss column's (every block needs S, the collocation tiles' loss sum, to
// scale an l1_sq_norm gradient), the collocation rows apart from the data
// rows; the groups' sums are joined in group order. Then a thread a
// parameter: g = S res + dat (l1_sq_norm) or res + dat, rounded once, and
// Adam (optax's scale_by_adam + scale(-lr)), one rounding per operation.
// Thread 0 of block 0 writes the loss metrics.
__global__ void __launch_bounds__(kAdamCols * kAdamGroups)
adam_kernel(Net net, Step call) {
  if (call.skip != nullptr && *call.skip != 0) return;
  const Step st = member_step(net, at_cursor(call), blockIdx.y);
  __shared__ double red[4][kAdamGroups][kAdamCols];
  const int c = threadIdx.x % kAdamCols, grp = threadIdx.x / kAdamCols;
  const int i = blockIdx.x * kAdamCols + c;
  const int nb = st.nb_f + st.nb_u;
  const long long row = net.n_params + 1;
  const float* col = st.partials + (i < net.n_params ? i : net.n_params);
  const float* loss = st.partials + net.n_params;
  double sum[4] = {0.0, 0.0, 0.0, 0.0};  // res, dat of the column; S, D of the loss
#pragma unroll 4
  for (int b = grp; b < st.nb_f; b += kAdamGroups) {
    sum[0] += col[b * row];
    sum[2] += loss[b * row];
  }
#pragma unroll 2
  for (int b = st.nb_f + grp; b < nb; b += kAdamGroups) {
    sum[1] += col[b * row];
    sum[3] += loss[b * row];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) red[q][grp][c] = sum[q];
  __syncthreads();
  if (grp != 0) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sum[q] = red[q][0][c];
    for (int g = 1; g < kAdamGroups; ++g) sum[q] += red[q][g][c];
  }
  const double res = sum[0], dat = sum[1], S = sum[2], D = sum[3];
  if (i == 0) {
    const float n_f = static_cast<float>(st.n_f);
    const float Sf = static_cast<float>(S);
    const float data_term = static_cast<float>(D) / static_cast<float>(st.n_u);
    float res_term = Sf;  // admm: sum of the per-point penalties
    if (st.kind == kMeanSq || st.kind == kL2Sq) res_term = Sf / n_f;
    if (st.kind == kL1Sq) res_term = Sf * Sf / n_f;
    if (st.value_and_grad) {
      *st.loss_out = data_term + res_term;
    } else {
      st.metrics[kMetricData] = data_term;
      st.metrics[kMetricRes] = res_term;
      st.metrics[kMetricLoss] = data_term + res_term;
      st.metrics[kMetricLam1] = st.lam1;
      st.metrics[kMetricLam2] = st.lam2;
      st.metrics[kMetricLbfgs] = 0.0f;
    }
  }
  if (i >= net.n_params) return;
  const float g = static_cast<float>(st.kind == kL1Sq ? S * res + dat : res + dat);
  if (st.grad_out != nullptr) st.grad_out[i] = g;
  if (st.value_and_grad) return;
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

// The post-update mode's data tile (blocks nb_tail on): the forward of its
// data points with the params, nothing kept, and the tile's sum of
// (u - u_data)^2 into its slot of the tail's sums.
__device__ void data_tile(const Net& net, const Step& st, float* w, float4* H, float* red, int T,
                          int plane) {
  const int ts = T + 1, p0 = (blockIdx.x - st.nb_tail) * T;
  const bool mine = threadIdx.x < T && p0 + static_cast<int>(threadIdx.x) < st.n_u;
  const float ud = mine ? st.u_data[p0 + threadIdx.x] : 0.0f;
  if (threadIdx.x < T) {
    const int i = p0 + threadIdx.x;
    const float xv = mine ? st.x_data[2 * i] : 0.0f;
    const float tv = mine ? st.x_data[2 * i + 1] : 0.0f;
    input_streams(H, ts, threadIdx.x, xv, tv, st);
  }
  stage(w, st.params_out, net.n_params);
  __syncthreads();
  const float4* X = tile_forward<false>(net, w, H, nullptr, T, plane);
  if (threadIdx.x < T) {
    const float d = tile_head(net, w, X, ts, threadIdx.x).x - ud;
    red[threadIdx.x] = mine ? d * d : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) st.tail_partials[blockIdx.x] = block_sum_ordered(red, T);
}

// One block a tile of st.tail_tile points of the new batch, a thread two
// units of a point of a layer: the points, then (for 'admm') z/dual at them
// with the new params, through the grad kernel's forward (nothing kept),
// and the tile's sum of |f - z|. In the post-update mode the blocks from
// nb_tail on are data tiles (data_tile).
__global__ void __launch_bounds__(kThreads)
tail_kernel(Net net, Step call) {
  const Step st = member_step(net, at_cursor(call), blockIdx.y);
  extern __shared__ float4 smem4[];
  const int T = st.tail_tile, ts = T + 1, plane = net.max_width * ts;
  float* w = reinterpret_cast<float*>(smem4);
  float4* H = smem4 + (net.n_params + 3) / 4;
  float* red = reinterpret_cast<float*>(H + 2 * plane);
  if (blockIdx.x >= static_cast<unsigned>(st.nb_tail)) {
    data_tile(net, st, w, H, red, T, plane);
    return;
  }
  const int p0 = blockIdx.x * T;
  // the point's dual, loaded now so that its latency overlaps the forward
  const bool mine = threadIdx.x < T && p0 + static_cast<int>(threadIdx.x) < st.n_f;
  const float dual = mine && st.kind == kAdmm ? st.dual[p0 + threadIdx.x] : 0.0f;
  if (threadIdx.x < T) {
    const int p = threadIdx.x, i = p0 + p;
    float xv = 0.0f, tv = 0.0f;
    if (i < st.n_f) {
      if (st.new_colloc != nullptr) {
        xv = st.new_colloc[2 * i];
        tv = st.new_colloc[2 * i + 1];
      } else {
        const uint4 r = philox4x32_10(
            make_uint4(static_cast<unsigned>(i), st.epoch_lo, st.epoch_hi, 0u),
            make_uint2(st.seed_lo, st.seed_hi));
        const float u0 = static_cast<float>(r.x >> 8) * 5.9604644775390625e-08f;
        const float u1 = static_cast<float>(r.y >> 8) * 5.9604644775390625e-08f;
        xv = __fadd_rn(st.lb0, __fmul_rn(__fsub_rn(st.ub0, st.lb0), u0));
        tv = __fadd_rn(st.lb1, __fmul_rn(__fsub_rn(st.ub1, st.lb1), u1));
      }
      st.colloc_out[2 * i] = xv;
      st.colloc_out[2 * i + 1] = tv;
    }
    input_streams(H, ts, p, xv, tv, st);
  }
  if (st.kind != kAdmm) return;  // no ADMM state: the tail only draws
  stage(w, st.params_out, net.n_params);
  __syncthreads();
  const float4* X = tile_forward<false>(net, w, H, nullptr, T, plane);
  if (threadIdx.x < T) {
    const int p = threadIdx.x, i = p0 + p;
    const float4 y = tile_head(net, w, X, ts, p);
    const float u = y.x, ux = y.y, ut = y.z, uxx = y.w;
    float val = 0.0f;
    if (mine) {
      const float f = ut + st.lam1 * u * ux - st.lam2 * uxx;
      const float v = __fadd_rn(f, __fdiv_rn(dual, st.rho));
      const float mag = fmaxf(__fsub_rn(fabsf(v), st.threshold), 0.0f);
      const float z = static_cast<float>((v > 0.0f) - (v < 0.0f)) * mag;
      st.z_out[i] = z;
      st.dual_out[i] = __fadd_rn(dual, __fmul_rn(st.rho, __fsub_rn(f, z)));
      val = fabsf(__fsub_rn(f, z));
    }
    red[p] = val;
  }
  __syncthreads();
  if (threadIdx.x == 0) st.tail_partials[blockIdx.x] = block_sum_ordered(red, T);
}

// Lane 0's sum of parts[0, n) in double: lane l adds l, l + 32, ... in turn,
// the lanes joined by a fixed shuffle tree.
__device__ __forceinline__ double warp_sum_ordered(const float* parts, int n, int lane) {
  double sum = 0.0;
  for (int b = lane; b < n; b += 32) sum += parts[b];
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) sum += __shfl_down_sync(0xffffffffu, sum, off);
  return sum;
}

// One block, a warp a member (members w, w + warps, ...): the misfit from
// the tail's per-tile sums (warp_sum_ordered); in the post-update mode (one
// member) the same warp then sums the data tiles' parts the same way and
// writes the rest of the metrics row; then (K9) the cursor on to the next
// epoch once every warp has read it.
__global__ void finalize_kernel(Net net, Step call, int n_members) {
  const Step at = at_cursor(call);
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int m = threadIdx.x / 32; m < n_members; m += warps) {
    const Step st = member_step(net, at, m);
    float misfit = 0.0f;
    if (st.kind == kAdmm) {
      misfit = static_cast<float>(warp_sum_ordered(st.tail_partials, st.nb_tail, lane)) /
               static_cast<float>(st.n_f);
    }
    if (lane == 0) st.metrics[kMetricMisfit] = misfit;
    if (!st.post_update) continue;
    const double D = warp_sum_ordered(st.tail_partials + st.nb_tail, st.nb_tail_data, lane);
    if (lane == 0) {
      const float data_term = static_cast<float>(D) / static_cast<float>(st.n_u);
      const float f = *st.f_in;
      st.metrics[kMetricLoss] = f;
      st.metrics[kMetricData] = data_term;
      st.metrics[kMetricRes] = __fsub_rn(f, data_term);
      st.metrics[kMetricLam1] = st.lam1;
      st.metrics[kMetricLam2] = st.lam2;
      st.metrics[kMetricLbfgs] = static_cast<float>(*st.iters_in);
    }
  }
  if (call.cursor == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) *call.cursor += 1;
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
  const size_t gsm = narrow_smem(net, st.tile, 2 * net.n_layers + 1);
  const size_t tsm = narrow_smem(net, st.tail_tile, 2);
  if (!narrow_tile_ok(net, st.tile) || !narrow_tile_ok(net, st.tail_tile) ||
      gsm > kSmemLimit || tsm > kSmemLimit || n_members < 1 || n_members > 65535 ||
      (n_members > 1 && st.members == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  st.nb_f = (st.n_f + st.tile - 1) / st.tile;
  st.nb_u = (st.n_u + st.tile - 1) / st.tile;
  st.nb_tail = (st.n_f + st.tail_tile - 1) / st.tail_tile;
  if (!launch_only) {
    PINNS_CHECK(allow_smem(grad_kernel, gsm));
    PINNS_CHECK(allow_smem(tail_kernel, tsm));
  }
  const unsigned E = static_cast<unsigned>(n_members);
  grad_kernel<<<dim3(st.nb_f + st.nb_u, E), kThreads, gsm, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  adam_kernel<<<dim3((net.n_params + kAdamCols - 1) / kAdamCols, E), kAdamCols * kAdamGroups, 0,
                s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  if (st.value_and_grad) return 0;  // K10: the loss and the gradient, nothing more
  const int tail_need = (st.tail_tile * ((net.max_width + 1) / 2) + 31) / 32 * 32;
  const int tail_threads = tail_need > kTailThreads ? tail_need : kTailThreads;
  tail_kernel<<<dim3(st.nb_tail, E), tail_threads, tsm, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  finalize_kernel<<<1, 256, 0, s>>>(net, st, n_members);
  return static_cast<int>(cudaGetLastError());
}

// The post-update mode: the tail (its collocation tiles, then its data
// tiles) and the finalize of one member, no grad or Adam launch.
int narrow_post_update(const Net& net, Step st, bool launch_only, cudaStream_t s) {
  const size_t tsm = narrow_smem(net, st.tail_tile, 2);
  if (!narrow_tile_ok(net, st.tail_tile) || tsm > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  st.nb_tail = (st.n_f + st.tail_tile - 1) / st.tail_tile;
  st.nb_tail_data = (st.n_u + st.tail_tile - 1) / st.tail_tile;
  st.post_update = 1;
  if (!launch_only) PINNS_CHECK(allow_smem(tail_kernel, tsm));
  const int tail_need = (st.tail_tile * ((net.max_width + 1) / 2) + 31) / 32 * 32;
  const int tail_threads = tail_need > kTailThreads ? tail_need : kTailThreads;
  tail_kernel<<<dim3(st.nb_tail + st.nb_tail_data, 1), tail_threads, tsm, s>>>(net, st);
  PINNS_CHECK(cudaGetLastError());
  finalize_kernel<<<1, 256, 0, s>>>(net, st, 1);
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
  kPartials, kTailPartials, kScratch, kMembers, kCursor, kSched, kLossOut, kSkip, kFIn,
  kItersIn, kNumPtrs
};
enum FloatArg {
  kLb0, kLb1, kUb0, kUb1, kLam1, kLam2, kRho, kLr, kOneMinusB1, kB1, kOneMinusB2,
  kB2, kEps, kBc1, kBc2, kThreshold, kNumFloats
};
enum IntArg {
  kNU, kNF, kKind, kExplicit, kPlanTile, kTailTile, kSeed, kEpoch, kDevice, kNfPad, kNuPad,
  kSplitRows, kSplits, kScratchFloats, kNMembers, kMetricsStride, kNewCollocStride,
  kLaunchOnly, kValueAndGrad, kNumInts
};

extern "C" int pinns_fused_step_sizes(int* n_ptrs, int* n_floats, int* n_ints) {
  *n_ptrs = kNumPtrs;
  *n_floats = kNumFloats;
  *n_ints = kNumInts;
  return 0;
}

namespace {

// The call's Step from the argument arrays (the enums above); false for a
// malformed call. Every mode's own fields start at zero.
bool fill_step(const int* dims, int n_layers, const long long* ptrs, const float* floats,
               const long long* ints, Net* net, Step* out) {
  if (n_layers < 2 || !make_net(dims, n_layers, net) || dims[n_layers] != 1 ||
      ints[kNU] < 1 || ints[kNF] < 1 || ints[kKind] < 0 || ints[kKind] > 3) {
    return false;
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
  st.loss_out = fp(kLossOut);
  st.skip = reinterpret_cast<const int*>(ptrs[kSkip]);
  st.f_in = fp(kFIn);
  st.iters_in = reinterpret_cast<const int*>(ptrs[kItersIn]);
  st.partials = fp(kPartials);
  st.tail_partials = fp(kTailPartials);
  st.members = reinterpret_cast<const Member*>(ptrs[kMembers]);
  st.cursor = reinterpret_cast<int*>(ptrs[kCursor]);
  st.sched = reinterpret_cast<const uint4*>(ptrs[kSched]);
  st.metrics_stride = ints[kMetricsStride];
  st.new_colloc_stride = ints[kNewCollocStride];
  if (st.cursor != nullptr && (st.sched == nullptr || (ptrs[kSched] & 15) != 0)) return false;
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
  st.nb_f = st.nb_u = st.nb_tail = st.nb_tail_data = 0;
  st.value_and_grad = static_cast<int>(ints[kValueAndGrad]);
  st.post_update = 0;
  const unsigned long long seed = static_cast<unsigned long long>(ints[kSeed]);
  const unsigned long long epoch = static_cast<unsigned long long>(ints[kEpoch]);
  st.seed_lo = static_cast<unsigned>(seed & 0xFFFFFFFFull);
  st.seed_hi = static_cast<unsigned>(seed >> 32);
  st.epoch_lo = static_cast<unsigned>(epoch & 0xFFFFFFFFull);
  st.epoch_hi = static_cast<unsigned>(epoch >> 32);
  *out = st;
  return true;
}

}  // namespace

// One epoch on `stream`. `dims` (host) holds n_layers + 1 widths; the other
// arrays follow the enums above. All device buffers are float32, contiguous,
// on device `ints[kDevice]`; the wrapper validated their shapes. A net whose
// widths are all at most 32 takes the narrow design (kPlanTile the grad
// kernel's tile, kTailTile, and the partials and tail_partials scratch;
// it refuses a tile whose block does not fit), for kNMembers members (K8: every per-member buffer stacked
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
// set-up. kValueAndGrad (with kLossOut, kGradOut and optionally kSkip) runs
// the value-and-grad mode; it refuses the wide design, a member table, more
// than one member and a cursor. Returns the CUDA error code of the first
// launch that failed (0 on
// success).
extern "C" int pinns_fused_step(const int* dims, int n_layers, const long long* ptrs,
                                const float* floats, const long long* ints, void* stream) {
  Net net;
  Step st;
  if (!fill_step(dims, n_layers, ptrs, floats, ints, &net, &st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (st.value_and_grad &&
      (net.max_width > kNarrowWidth || ints[kNMembers] != 1 || st.members != nullptr ||
       st.loss_out == nullptr || st.grad_out == nullptr || st.cursor != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool launch_only = ints[kLaunchOnly] != 0;
  if (!launch_only) PINNS_CHECK(cudaSetDevice(static_cast<int>(ints[kDevice])));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_members = static_cast<int>(ints[kNMembers]);
  if (net.max_width <= kNarrowWidth) return narrow_epoch(net, st, n_members, launch_only, s);
  if (n_members != 1 || st.members != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan wp{static_cast<int>(ints[kNfPad]), static_cast<int>(ints[kNuPad]),
                    static_cast<int>(ints[kPlanTile]), static_cast<int>(ints[kSplitRows]),
                    static_cast<int>(ints[kSplits])};
  float* scratch = reinterpret_cast<float*>(ptrs[kScratch]);
  if (!wide_plan_ok(net, st, wp, scratch)) return static_cast<int>(cudaErrorInvalidValue);
  const long long scratch_floats = ints[kScratchFloats];
  return wide_epoch(net, st, wp, scratch, scratch_floats, s);
}

// The post-update mode (the header's): the narrow tail and finalize kernels
// of one member after one of K10's solves, on `stream`, with the arrays of
// pinns_fused_step. It needs kParamsOut (the solve's net params), kColloc
// and kCollocOut (the solve's batch, written in place), for 'admm' kZ =
// kZOut and kDual = kDualOut (the solve's z and dual, updated in place),
// kXData, kUData, kTailPartials (ceil(N_f / tail_tile) + ceil(N_u /
// tail_tile) floats), kMetrics (rows of 7, kMetricsStride apart), kCursor
// and kSched (the Philox epoch words a row), kMembers (one row: the seed,
// rho and the threshold), kFIn and kItersIn (K10's sf[F_F] and si[I_K]);
// kNewColloc is the fed points (kNewCollocStride floats a row), or the
// batch itself with a stride of 0 (a fixed batch), or null (the Philox
// draw). It refuses the wide design, another member count, a missing
// buffer and z / dual buffers that do not match the kind.
extern "C" int pinns_fused_post_update(const int* dims, int n_layers, const long long* ptrs,
                                       const float* floats, const long long* ints,
                                       void* stream) {
  Net net;
  Step st;
  if (!fill_step(dims, n_layers, ptrs, floats, ints, &net, &st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool admm = st.kind == kAdmm;
  const bool state_ok = admm ? (st.z != nullptr && st.z == st.z_out && st.dual != nullptr &&
                                st.dual == st.dual_out)
                             : (st.z == nullptr && st.z_out == nullptr && st.dual == nullptr &&
                                st.dual_out == nullptr);
  if (net.max_width > kNarrowWidth || ints[kNMembers] != 1 || st.members == nullptr ||
      st.value_and_grad || st.cursor == nullptr || st.metrics == nullptr ||
      st.f_in == nullptr || st.iters_in == nullptr || st.params_out == nullptr ||
      st.colloc == nullptr || st.colloc_out != st.colloc || st.tail_partials == nullptr ||
      st.x_data == nullptr || st.u_data == nullptr || !state_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool launch_only = ints[kLaunchOnly] != 0;
  if (!launch_only) PINNS_CHECK(cudaSetDevice(static_cast<int>(ints[kDevice])));
  return narrow_post_update(net, st, launch_only, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pinns_fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
