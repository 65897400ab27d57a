// K10, the L-BFGS solve on the device, for Hopper (sm_90a).
//
// Replaces the XLA program of pinns_tpu/opt/lbfgs.py::lbfgs_minimize (:194,
// its lax.while_loop :306) with _zoom_linesearch (:38, its loop :163) and
// _two_loop_direction (:167, its fori_loops :180 and :190). JAX runs the whole
// solve as one device program; pinns_tpu_torch/opt/lbfgs.py::lbfgs_minimize
// runs the same branches from the host, one host sync per line-search
// evaluation. Here every decision is taken on the device, so that a solve is
// a chain of *evaluation steps* that a CUDA graph can replay with no host
// read between them (ops/kernels/lbfgs.py::DeviceLBFGS):
//
//   value-and-grad  (phi, g) at the trial point xt, into phi_t and gt: K3's
//                   value-and-grad mode (csrc/fused_step.cu), or any function
//                   that reads the done flag and writes those two buffers
//   control_kernel  takes the evaluation: the first one gives f and g (and
//                   the gradient test); later ones (phi, phi' = gt . d)
//                   advance the bracket or the zoom of the strong-Wolfe
//                   search (Nocedal & Wright alg. 3.5 / 3.6, bisection trial
//                   points, the evaluation budget, the interval-dead test, the
//                   best sufficient decrease as the fallback), then either
//                   sets the next trial point xt = x + a d or ends the
//                   iteration: s and y, the curvature test, the history
//                   update, gamma = s.y / y.y, the step and SciPy's stopping
//                   rules on g, f and the iteration cap
//   direction_kernel  at an iteration's start (need_dir): the two-loop
//                   recursion d = -H g over the `count` newest (s, y) pairs
//                   of the circular history, the descent guard, the first step
//                   min(1, 1/sum|g|), the search's initial state and xt.
//
// reset_kernel writes a solve's initial state (xt = x0, stage init); with
// no x0 it resets in place from the iterate x that the last solve left
// (ops/kernels/lbfgs.py::LBFGSChunk: the next outer epoch's x0 is that x, so
// no host copy). Once the done flag is set every launch of a step reads it
// and returns, so a replay of R steps past the end costs R empty launches of
// each kernel.
//
// The state lives in device memory: an int array (si) and a float array (sf)
// whose slots are the enums below (ops/kernels/lbfgs.py names them I_* and
// F_*), six vectors of n floats (vec: x, g, d, xt, gt, g_best), the history
// (hist: s then y, each m x n) and its rho (m). Every scalar decision is the
// host loop's float32 arithmetic in its association, spelled with
// round-to-nearest intrinsics (nothing is contracted into an FMA: one
// contracted f0 + c1 a phi'0 moves a Wolfe test), and the float32 constants
// (c1, c2, ftol, gtol, 1e-12, 1e-10, 1e-30, 1e8) come from the wrapper as
// numpy rounds them. min and max propagate NaN, as jnp.minimum / maximum do.
//
// Every sum runs in one fixed order, so two solves from one state agree bit
// for bit (no atomics): a virtual block of 1024 threads, thread t summing
// entries t, t + 1024, ... in turn, a warp's 32 sums meeting in a butterfly
// (offsets 16, 8, 4, 2, 1), and the 32 warps' sums in the same tree. The
// plain versions in ops/kernels/lbfgs.py spell that order
// (block_sum_reference), so they agree with these kernels bit for bit.
//
// The layout: the reset and control kernels run that virtual block as one
// block (the control kernel's warp sums meet behind one __syncthreads); the
// direction kernel runs it as a thread block cluster of kCtas = 8 CTAs of 128
// threads. Local thread j of rank c is virtual thread 128 c + j and owns the
// same entries as in one block. On the cluster a sum never passes a
// __syncthreads or a cluster barrier: each warp reduces its
// part by the butterfly, and lane r < 8 sends the warp's sum to CTA r, into
// slot red[turn][k][warp] of its shared memory: by st.async, whose bytes
// complete CTA r's mbarrier bar[turn] (release, cluster scope), or, to its
// own CTA, by a shared store and an arrival. Every warp of every CTA waits
// on its own CTA's barrier (acquire) and runs the 32-way tree on the 32
// sums in warp order, so every CTA holds the same bits. The two turns make
// the slots safe to reuse: no warp can reach exchange j + 2 before every
// warp has sent exchange j + 1, which each does after reading exchange j's
// sums. One exchange carries up to kMaxSums sums (d.g and sum|g| here; the
// control kernel's s.y, s.s and y.y behind its one barrier), each in its own
// tree. Thread 0 of every CTA does the
// scalar work on identical inputs; rank 0 alone writes si and sf. One
// cluster barrier follows the mbarriers' initialisation, and one precedes
// the exit (no CTA exits while another may still write into its shared
// memory); both are split into an arrive and a later wait.
//
// What bounds it on the H100: latency. At abgrall_admm's 8x20 (n = 3,023)
// the vectors are 12 KB, and the two-loop at a full history (m = 50) reads
// 1.2 MB of (s, y) pairs; its bound is those bytes once (0.37 us at
// 3.35 TB/s), its time 2 count dependent exchanges of about 0.5 us each
// (scripts/k10_step_clock.py: the butterfly, the DSMEM round trip and the
// tree). Spread over 8 SMs, a step reads 3 KB an SM, and loading the next
// step's vector before each exchange hides L2's latency. The direction
// kernel's *resident* design also keeps each CTA's entries of the pairs in
// its shared memory, stored as the first loop reads them, so the second
// loop reads no global memory and each pair leaves L2 once a launch; the
// *streamed* design reads them again (the scope's deepest nets, whose pairs
// no CTA holds). q lives in registers up to 8 entries a thread, else in
// shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {
namespace k10 {

constexpr int kThreads = 1024;  // the virtual block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 3;                // sums one exchange carries
constexpr int kMaxPer = 8;                 // entries of q a thread holds in registers
constexpr int kCtas = 8;                   // the direction kernel's cluster (portable)
constexpr int kCtaThreads = kThreads / kCtas;
constexpr size_t kSmemLimit = 232448;      // a block's shared memory on sm_90 (227 KB)
constexpr size_t kStaticReserve = 1024;    // the static shared memory the plan reserves (Shared)
constexpr int kErrUnplaced = -2;           // the cluster cannot be placed on the card

// the state's int slots (ops/kernels/lbfgs.py: I_DONE, ...)
enum IntSlot {
  kDone, kConverged, kK, kEvals, kStage, kNeedDir, kLsEvals, kCount, kHead, kMode,
  kBranches, kMaxIters, kMaxLs, kNumInts
};
// the float slots (F_F, ...): the iterate's f, the history's gamma, the
// search's state, the trial's phi (written by the value-and-grad), the
// constants
enum FloatSlot {
  kF, kGamma, kDphi0, kALo, kPhiLo, kDphiLo, kAHi, kPhiHi, kAPrev, kPhiPrev, kDphiPrev,
  kATrial, kABest, kFBest, kPhiT, kC1, kC2, kFtol, kGtol, kEpsDead, kEpsCurv, kTiny, kAMax,
  kEpsStep, kNumFloats
};
enum Row { kX, kG, kD, kXT, kGT, kGB, kRows };
enum Stage { kInit = 0, kSearch = 1 };
// the branches a solve took, or-ed into si[kBranches] (BRANCHES in the wrapper)
enum Branch {
  kBrExtend = 1 << 0, kBrZoomHi = 1 << 1, kBrZoomRev = 1 << 2, kBrZoomCondHi = 1 << 3,
  kBrZoomLo = 1 << 4, kBrSwap = 1 << 5, kBrAccept = 1 << 6, kBrOutOfBudget = 1 << 7,
  kBrIntervalDead = 1 << 8, kBrFallback = 1 << 9, kBrFailed = 1 << 10,
  kBrDescentGuard = 1 << 11, kBrCurvSkip = 1 << 12, kBrStored = 1 << 13
};
// the control kernel's per-launch decisions (not kept)
enum Temp { kTBetter, kTEnded, kTOk, kTStore, kTOldHead, kNumTemps };

struct __align__(16) Shared {
  float red[2][kMaxSums][kWarps];  // the exchanges' slots, two turns
  unsigned long long bar[2];       // their mbarriers
  int i[kNumInts];
  float f[kNumFloats];
  int t[kNumTemps];
  float f_old;
};
static_assert(sizeof(Shared) <= kStaticReserve, "Shared outgrew the plan's reserve");

struct Consts {
  float c1, c2, ftol, gtol, eps_dead, eps_curv, tiny, a_max, eps_step;
};

__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// A warp's butterfly (offsets 16, 8, 4, 2, 1): every lane ends with lane
// 0's sum, which is the sum in the tree w[l] + w[l + off] that the plain
// versions spell.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? max_nan(a, b) : __fadd_rn(a, b);
}

// The 32 warp sums w (shared memory, warp order) in the butterfly's tree,
// in registers: w[l] + w[l + off] for off = 16, ..., 1, lane 0's sum bit for
// bit (every lane of the butterfly holds it). Each level a loop of constant
// bounds, so that r stays in registers.
template <bool kMax>
__device__ __forceinline__ float tree32(const float* w) {
  float r[kWarps];
#pragma unroll
  for (int l = 0; l < kWarps; l += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + l);
    r[l] = v.x;
    r[l + 1] = v.y;
    r[l + 2] = v.z;
    r[l + 3] = v.w;
  }
#pragma unroll
  for (int l = 0; l < 16; ++l) r[l] = combine<kMax>(r[l], r[l + 16]);
#pragma unroll
  for (int l = 0; l < 8; ++l) r[l] = combine<kMax>(r[l], r[l + 8]);
#pragma unroll
  for (int l = 0; l < 4; ++l) r[l] = combine<kMax>(r[l], r[l + 4]);
#pragma unroll
  for (int l = 0; l < 2; ++l) r[l] = combine<kMax>(r[l], r[l + 2]);
  return combine<kMax>(r[0], r[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `addr` (this CTA's shared memory) in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Relaxed: the arrive orders no memory (a release here is a GPU-scope
// MEMBAR). The barriers' initialisation is published by
// fence.mbarrier_init; the exit's barrier only keeps every CTA alive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// This thread's virtual thread: rank * blockDim.x + threadIdx.x.
__device__ __forceinline__ int virtual_thread() {
  return static_cast<int>(cluster_rank() * blockDim.x + threadIdx.x);
}

// One exchange's state in every thread: the turn, the two barriers' phase
// parities, and where the thread sits in the virtual block. kCluster false:
// the control kernel's one block, whose sums meet behind a __syncthreads.
template <bool kCluster>
struct Exchange {
  Shared* sh;
  uint32_t rank, ranks;
  int t;  // the virtual thread: rank * blockDim.x + threadIdx.x
  int turn;
  uint32_t parity;
};

// Initialise the exchange's barriers and arrive on the cluster barrier that
// publishes them; the caller waits on it (cluster_wait) before its first
// gather. A phase of bar[turn] completes after one arrival a warp of this
// CTA (its own sum, stored locally), thread 0's arrival that expects the
// bytes of the other CTAs' warps, and those bytes.
template <bool kCluster>
__device__ __forceinline__ Exchange<kCluster> exchange_begin(Shared& sh) {
  Exchange<kCluster> ex;
  if constexpr (kCluster) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&sh.bar[b])),
                     "r"(1 + static_cast<int>(blockDim.x) / 32)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive();
    ex.rank = cluster_rank();
    ex.ranks = cluster_ranks();
  } else {
    ex.rank = 0;
    ex.ranks = 1;
  }
  ex.sh = &sh;
  ex.t = virtual_thread();
  ex.turn = 0;
  ex.parity = 0;
  return ex;
}

// The virtual block's K sums (or maxima) of every thread's v[k], in every
// thread of every CTA, each in the block's tree (see the file's head). Lane
// r < 8 of each warp sends the warp's sums to CTA r: to its own CTA by a
// shared store and an arrival (release), to the others by st.async, whose
// bytes complete the remote barrier's transaction count (release, cluster
// scope); every thread waits on its own CTA's barrier (acquire, cluster).
// One block: lane 0 of each warp stores, then one __syncthreads.
template <int K, bool kMax, bool kCluster>
__device__ __forceinline__ void gather(float (&v)[K], Exchange<kCluster>& ex) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = kMax ? warp_max(v[k]) : warp_sum(v[k]);
  Shared& sh = *ex.sh;
  const uint32_t lane = threadIdx.x & 31;
  const int warp = ex.t >> 5;
  if constexpr (!kCluster) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh.red[ex.turn][k][warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = tree32<kMax>(sh.red[ex.turn][k]);
    ex.turn ^= 1;
    return;
  }
  const uint32_t bar = smem_addr(&sh.bar[ex.turn]);
  uint64_t state;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 %0, [%1], %2;"
                 : "=l"(state)
                 : "r"(bar), "r"(K * 4 * (kWarps - static_cast<int>(blockDim.x) / 32))
                 : "memory");
  }
  if (lane == ex.rank) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh.red[ex.turn][k][warp] = v[k];
    asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 %0, [%1];"
                 : "=l"(state)
                 : "r"(bar)
                 : "memory");
  } else if (lane < ex.ranks) {
    const uint32_t remote_bar = map_rank(bar, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      asm volatile(
          "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
              map_rank(smem_addr(&sh.red[ex.turn][k][warp]), lane)),
          "r"(__float_as_uint(v[k])), "r"(remote_bar)
          : "memory");
    }
  }
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "K10_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n\t"
      "@!P1 bra K10_WAIT;\n}" ::"r"(bar),
      "r"((ex.parity >> ex.turn) & 1u)
      : "memory");
  ex.parity ^= 1u << ex.turn;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = tree32<kMax>(sh.red[ex.turn][k]);
  ex.turn ^= 1;
}

template <bool kCluster>
__device__ __forceinline__ float gather_sum(float v, Exchange<kCluster>& ex) {
  float s[1] = {v};
  gather<1, false>(s, ex);
  return s[0];
}

template <bool kCluster>
__device__ __forceinline__ float gather_max(float v, Exchange<kCluster>& ex) {
  float s[1] = {v};
  gather<1, true>(s, ex);
  return s[0];
}

__device__ __forceinline__ void load_state(Shared& sh, const int* si, const float* sf) {
  if (threadIdx.x < kNumInts) sh.i[threadIdx.x] = si[threadIdx.x];
  if (threadIdx.x < kNumFloats) sh.f[threadIdx.x] = sf[threadIdx.x];
  __syncthreads();
}

// Rank 0 writes the state.
__device__ __forceinline__ void finish(const Shared& sh, int* si, float* sf, uint32_t rank) {
  __syncthreads();
  if (rank == 0) {
    if (threadIdx.x < kNumInts) si[threadIdx.x] = sh.i[threadIdx.x];
    if (threadIdx.x < kNumFloats) sf[threadIdx.x] = sh.f[threadIdx.x];
  }
}

// One evaluation (phi, dphi) at a = F[kATrial] into the search (thread 0):
// _zoom_linesearch's body. Sets the temps better (a new best point) and
// ended (accept or fail), and at the end ok.
__device__ void search_update(int* I, float* F, int* T, float phi, float dphi) {
  const float a = F[kATrial], f0 = F[kF], dphi0 = F[kDphi0];
  const int evals = I[kLsEvals] + 1;
  I[kLsEvals] = evals;
  const bool out_of_budget = evals >= I[kMaxLs];
  const bool wolfe1 = phi <= __fadd_rn(f0, __fmul_rn(__fmul_rn(F[kC1], a), dphi0));
  const bool wolfe2 = fabsf(dphi) <= __fmul_rn(-F[kC2], dphi0);
  const bool accept = wolfe1 && wolfe2;
  int br = 0;
  if (I[kMode] == 0) {  // alg. 3.5: bracket
    const bool hi_cond = !wolfe1 || (phi >= F[kPhiPrev] && evals > 1);  // zoom(a_prev, a)
    const bool to_rev = !hi_cond && dphi >= 0.0f;                       // zoom(a, a_prev)
    if (hi_cond) {
      F[kALo] = F[kAPrev];
      F[kPhiLo] = F[kPhiPrev];
      F[kDphiLo] = F[kDphiPrev];
      F[kAHi] = a;
      F[kPhiHi] = phi;
      br |= kBrZoomHi;
    } else if (to_rev) {
      F[kAHi] = F[kAPrev];
      F[kPhiHi] = F[kPhiPrev];
      F[kALo] = a;
      F[kPhiLo] = phi;
      F[kDphiLo] = dphi;
      br |= kBrZoomRev;
    }
    if (hi_cond || to_rev) {
      I[kMode] = 1;
      F[kATrial] = __fmul_rn(0.5f, __fadd_rn(F[kALo], F[kAHi]));
    } else {
      F[kATrial] = min_nan(__fmul_rn(2.0f, a), F[kAMax]);
      br |= kBrExtend;
    }
    F[kAPrev] = a;
    F[kPhiPrev] = phi;
    F[kDphiPrev] = dphi;
  } else {  // alg. 3.6 with bisection trial points
    const bool cond_hi = !wolfe1 || phi >= F[kPhiLo];
    const bool swap = !cond_hi && __fmul_rn(dphi, __fsub_rn(F[kAHi], F[kALo])) >= 0.0f;
    if (cond_hi) {
      F[kAHi] = a;
      F[kPhiHi] = phi;
      br |= kBrZoomCondHi;
    } else {
      if (swap) {
        F[kAHi] = F[kALo];
        F[kPhiHi] = F[kPhiLo];
        br |= kBrSwap;
      }
      F[kALo] = a;
      F[kPhiLo] = phi;
      F[kDphiLo] = dphi;
      br |= kBrZoomLo;
    }
    F[kATrial] = __fmul_rn(0.5f, __fadd_rn(F[kALo], F[kAHi]));
  }
  const bool interval_dead =
      I[kMode] == 1 && fabsf(__fsub_rn(F[kAHi], F[kALo])) <=
                           __fmul_rn(F[kEpsDead], max_nan(1.0f, fabsf(F[kAHi])));
  const bool fail = !accept && (out_of_budget || interval_dead);
  const bool better = (wolfe1 && phi < F[kFBest]) || accept;
  if (better) {
    F[kABest] = a;
    F[kFBest] = phi;
  }
  T[kTBetter] = better;
  T[kTEnded] = accept || fail;
  T[kTOk] = accept || F[kFBest] < f0;
  if (accept) br |= kBrAccept;
  if (fail) {
    if (out_of_budget) br |= kBrOutOfBudget;
    if (interval_dead) br |= kBrIntervalDead;
    br |= T[kTOk] ? kBrFallback : kBrFailed;
  }
  I[kBranches] |= br;
}

__global__ void reset_kernel(int* si, float* sf, float* vec, const float* x0, int n,
                             int max_iters, int max_ls, Consts c) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kNumInts; ++k) si[k] = 0;
    for (int k = 0; k < kNumFloats; ++k) sf[k] = 0.0f;
    si[kStage] = kInit;
    si[kMaxIters] = max_iters;
    si[kMaxLs] = max_ls;
    sf[kGamma] = 1.0f;
    sf[kC1] = c.c1;
    sf[kC2] = c.c2;
    sf[kFtol] = c.ftol;
    sf[kGtol] = c.gtol;
    sf[kEpsDead] = c.eps_dead;
    sf[kEpsCurv] = c.eps_curv;
    sf[kTiny] = c.tiny;
    sf[kAMax] = c.a_max;
    sf[kEpsStep] = c.eps_step;
  }
  // a null x0: the reset in place, the next solve from the last one's
  // iterate (x stays, xt takes it); each thread reads only its own entries
  const size_t N = n;
  const float* src = x0 != nullptr ? x0 : vec + kX * N;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = src[i];
    if (x0 != nullptr) vec[kX * N + i] = v;
    vec[kXT * N + i] = v;
    vec[kGT * N + i] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
control_kernel(int* si, float* sf, float* vec, float* hist, float* rho, int n, int m) {
  __shared__ Shared sh;
  const int t = virtual_thread();
  const size_t N = n;
  float* x = vec + kX * N;
  float* g = vec + kG * N;
  const float* d = vec + kD * N;
  float* xt = vec + kXT * N;
  const float* gt = vec + kGT * N;
  float* gb = vec + kGB * N;
  // this thread's parts of phi' = gt . d and of max|gt|, read beside the
  // state (the first evaluation takes the maximum, every other the dot)
  float part = 0.0f, mx = 0.0f;
  for (int i = t; i < n; i += kThreads) {
    part = __fadd_rn(part, __fmul_rn(gt[i], d[i]));
    mx = max_nan(mx, fabsf(gt[i]));
  }
  load_state(sh, si, sf);
  if (sh.i[kDone]) return;
  auto ex = exchange_begin<false>(sh);
  int* I = sh.i;
  float* F = sh.f;
  int* T = sh.t;

  if (I[kStage] == kInit) {  // the first evaluation: f and g at x0
    for (int i = t; i < n; i += kThreads) g[i] = gt[i];
    mx = gather_max(mx, ex);
    if (threadIdx.x == 0) {
      F[kF] = F[kPhiT];
      I[kEvals] = 1;
      if (mx <= F[kGtol]) {  // an already-converged start
        I[kDone] = 1;
        I[kConverged] = 1;
      } else {
        I[kNeedDir] = 1;
      }
    }
    finish(sh, si, sf, 0);
    return;
  }

  const float dphi = gather_sum(part, ex);
  if (threadIdx.x == 0) search_update(I, F, T, F[kPhiT], dphi);
  __syncthreads();
  if (T[kTBetter]) {
    for (int i = t; i < n; i += kThreads) gb[i] = gt[i];
  }
  if (!T[kTEnded]) {  // the next trial point
    const float a = F[kATrial];
    for (int i = t; i < n; i += kThreads) xt[i] = __fadd_rn(x[i], __fmul_rn(a, d[i]));
    finish(sh, si, sf, 0);
    return;
  }

  // the end of the iteration: x_new = x + a d, s = x_new - x, y = g_new - g;
  // s.y, s.s and y.y in one exchange, each in its own tree
  const float a = F[kABest];
  float p[3] = {0.0f, 0.0f, 0.0f};
  for (int i = t; i < n; i += kThreads) {
    const float s = __fsub_rn(__fadd_rn(x[i], __fmul_rn(a, d[i])), x[i]);
    const float y = __fsub_rn(gb[i], g[i]);
    p[0] = __fadd_rn(p[0], __fmul_rn(s, y));
    p[1] = __fadd_rn(p[1], __fmul_rn(s, s));
    p[2] = __fadd_rn(p[2], __fmul_rn(y, y));
  }
  gather<3, false>(p, ex);
  const float sy = p[0], ss = p[1], yy = p[2];
  if (threadIdx.x == 0) {
    const bool ok = T[kTOk];
    const float ns = __fsqrt_rn(ss), ny = __fsqrt_rn(yy);
    const bool store = ok && sy > __fmul_rn(__fmul_rn(F[kEpsCurv], ns), ny);
    T[kTStore] = store;
    T[kTOldHead] = I[kHead];
    if (store) {
      rho[I[kHead]] = __fdiv_rn(1.0f, max_nan(sy, F[kTiny]));
      I[kHead] = (I[kHead] + 1) % m;
      I[kCount] = I[kCount] + 1 < m ? I[kCount] + 1 : m;
      F[kGamma] = __fdiv_rn(sy, max_nan(yy, F[kTiny]));
      I[kBranches] |= kBrStored;
    } else if (ok) {
      I[kBranches] |= kBrCurvSkip;
    }
    sh.f_old = F[kF];
    if (ok) F[kF] = F[kFBest];
  }
  __syncthreads();
  const bool ok = T[kTOk], store = T[kTStore];
  float* hs = hist + static_cast<size_t>(T[kTOldHead]) * N;
  float* hy = hist + (static_cast<size_t>(m) + T[kTOldHead]) * N;
  mx = 0.0f;
  for (int i = t; i < n; i += kThreads) {
    const float xn = __fadd_rn(x[i], __fmul_rn(a, d[i]));
    if (store) {
      hs[i] = __fsub_rn(xn, x[i]);
      hy[i] = __fsub_rn(gb[i], g[i]);
    }
    if (ok) {
      x[i] = xn;
      g[i] = gb[i];
    }
    mx = max_nan(mx, fabsf(g[i]));
  }
  mx = gather_max(mx, ex);
  if (threadIdx.x == 0) {  // SciPy's stopping rules
    const float f_old = sh.f_old, f = F[kF];
    const bool g_small = mx <= F[kGtol];
    const bool f_flat =
        ok && __fsub_rn(f_old, f) <=
                  __fmul_rn(F[kFtol], max_nan(max_nan(fabsf(f_old), fabsf(f)), 1.0f));
    const bool converged = g_small || f_flat;
    I[kK] += 1;
    I[kEvals] += I[kLsEvals];
    I[kConverged] = converged;
    if (converged || I[kK] >= I[kMaxIters] || !ok) {
      I[kDone] = 1;
    } else {
      I[kNeedDir] = 1;
    }
  }
  finish(sh, si, sf, 0);
}

// The pair j of the first loop (newest first) in the circular history; the
// second loop walks the same slots back (j = count - 1, ..., 0).
__device__ __forceinline__ int newest(int head, int j, int m) { return ((head - 1 - j) % m + m) % m; }

// q (then r) of this thread: kPer entries in registers, or (kPer = 0) its
// per entries in shared memory, entry k at s[k * blockDim.x].
template <int kPer>
struct QVec {
  float r[kPer];
  __device__ __forceinline__ float& operator[](int k) { return r[k]; }
};
template <>
struct QVec<0> {
  float* s;
  __device__ __forceinline__ float& operator[](int k) { return s[k * blockDim.x]; }
};

// The direction kernel: one cluster of kCtas = 8 CTAs of 128 threads, the
// virtual block's thread t owning entries t, t + 1024, ...
// (per of them). kPer: q in registers (1, 2, 4, 8 entries) or in shared
// memory (0). The first loop reads each pair from global memory (L2), the
// next step's dot vector loaded before each exchange; kResident: it also
// stores this thread's entries into the CTA's shared memory, from which the
// second loop reads them (else from global memory again, the streamed
// design). Dynamic shared memory, in floats: alpha (a row of m for each
// warp: its lane 0 writes, its lanes read), rho of the count newest pairs
// (m), their slots in the circular history (m ints), q when kPer = 0 (per x
// blockDim.x), the resident pairs (slot j's s, then its y, each per x
// blockDim.x, m slots).
template <int kPer, bool kResident>
__global__ void __launch_bounds__(kCtaThreads)
direction_kernel(int* si, float* sf, float* vec, const float* hist, const float* rho, int n,
                 int m) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) float dyn[];
  constexpr bool kRegs = kPer > 0;
  const int tpb = blockDim.x, tid = threadIdx.x, t = virtual_thread();
  const size_t N = n;
  const float* x = vec + kX * N;
  const float* g = vec + kG * N;
  float* d = vec + kD * N;
  float* xt = vec + kXT * N;
  float* gb = vec + kGB * N;
  QVec<kPer> q;
  // g's and x's entries (registers), read beside the state
  float gr[kRegs ? kPer : 1], xr[kRegs ? kPer : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + k * kThreads;
      gr[k] = i < n ? g[i] : 0.0f;
      xr[k] = i < n ? x[i] : 0.0f;
      q[k] = gr[k];
    }
  }
  load_state(sh, si, sf);
  if (sh.i[kDone] || !sh.i[kNeedDir]) return;
  const int count = sh.i[kCount], head = sh.i[kHead];
  const float gamma = sh.f[kGamma];
  const int per = (n + kThreads - 1) / kThreads;
  const int walk = kRegs ? kPer : per;  // the entries a thread walks
  // entry k of this thread exists: always below the last (kPer is per)
  auto in_range = [&](int k) { return (kRegs && k < kPer - 1) || t + k * kThreads < n; };
  float* alpha = dyn + (tid >> 5) * m;
  float* rho_s = dyn + (tpb >> 5) * m;
  int* slot = reinterpret_cast<int*>(rho_s + m);
  float* qs = rho_s + 2 * m;
  float* hs = qs + (kRegs ? 0 : per * tpb);
  for (int j = tid; j < count; j += tpb) {
    slot[j] = newest(head, j, m);
    rho_s[j] = rho[slot[j]];
  }
  __syncthreads();  // rho_s and slot
  auto ex = exchange_begin<true>(sh);
  if constexpr (!kRegs) {
    q.s = qs + tid;
    for (int k = 0; k < per; ++k) {
      const int i = t + k * kThreads;
      q[k] = i < n ? g[i] : 0.0f;
    }
  }
  cluster_wait();  // every CTA's barriers initialised

  // this thread's entries of slot j's s (which 0) or y (which 1): in global
  // memory (entry k at [k * kThreads]) and, resident, in the CTA's copy
  // (entry k at [k * tpb]); the second loop reads them at `back`
  auto global_row = [&](int j, int which) -> const float* {
    return hist + (static_cast<size_t>(which) * m + slot[j]) * N + t;
  };
  auto copy_row = [&](int j, int which) -> float* {
    return hs + static_cast<size_t>(2 * j + which) * per * tpb + tid;
  };
  auto back = [&](int j, int which) -> const float* {
    if (kResident) return copy_row(j, which);
    return global_row(j, which);
  };
  const int back_stride = kResident ? tpb : kThreads;

  if constexpr (kRegs) {
    // first loop, newest first: alpha = rho s.q, q -= alpha y; the step's
    // dot vector a was loaded a step ahead
    float a[kPer];
    if (count > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[k] = in_range(k) ? global_row(0, 0)[k * kThreads] : 0.0f;
      }
    }
    for (int j = 0; j < count; ++j) {
      const float* y = global_row(j, 1);
      float b[kPer], nxt[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool valid = in_range(k);
        b[k] = valid ? y[k * kThreads] : 0.0f;
        nxt[k] = valid && j + 1 < count ? global_row(j + 1, 0)[k * kThreads] : 0.0f;
      }
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (in_range(k)) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));
      }
      const float al = __fmul_rn(rho_s[j], gather_sum(p, ex));
      if ((tid & 31) == 0) alpha[j] = al;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        q[k] = __fsub_rn(q[k], __fmul_rn(al, b[k]));
        if (kResident && k < per) {  // the copy holds per entries a thread
          copy_row(j, 0)[k * tpb] = a[k];
          copy_row(j, 1)[k * tpb] = b[k];
        }
        a[k] = nxt[k];
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPer; ++k) q[k] = __fmul_rn(gamma, q[k]);
    // second loop, oldest first: beta = rho y.r, r += (alpha - beta) s
    if (count > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[k] = in_range(k) ? back(count - 1, 1)[k * back_stride] : 0.0f;
      }
    }
    for (int j = count - 1; j >= 0; --j) {
      const float* s = back(j, 0);
      float b[kPer], nxt[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool valid = in_range(k);
        b[k] = valid ? s[k * back_stride] : 0.0f;
        nxt[k] = valid && j > 0 ? back(j - 1, 1)[k * back_stride] : 0.0f;
      }
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (in_range(k)) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));
      }
      const float beta = __fmul_rn(rho_s[j], gather_sum(p, ex));
      const float corr = __fsub_rn(alpha[j], beta);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        q[k] = __fadd_rn(q[k], __fmul_rn(corr, b[k]));
        a[k] = nxt[k];
      }
    }
  } else {
    for (int j = 0; j < count; ++j) {
      const float* s = global_row(j, 0);
      const float* y = global_row(j, 1);
      float p = 0.0f;
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) {
          const float sk = s[k * kThreads];
          if (kResident) copy_row(j, 0)[k * tpb] = sk;
          p = __fadd_rn(p, __fmul_rn(sk, q[k]));
        }
      }
      const float al = __fmul_rn(rho_s[j], gather_sum(p, ex));
      if ((tid & 31) == 0) alpha[j] = al;
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) {
          const float yk = y[k * kThreads];
          if (kResident) copy_row(j, 1)[k * tpb] = yk;
          q[k] = __fsub_rn(q[k], __fmul_rn(al, yk));
        }
      }
    }
    __syncwarp();
    for (int k = 0; k < per; ++k) q[k] = __fmul_rn(gamma, q[k]);
    for (int j = count - 1; j >= 0; --j) {
      const float* y = back(j, 1);
      const float* s = back(j, 0);
      float p = 0.0f;
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) p = __fadd_rn(p, __fmul_rn(y[k * back_stride], q[k]));
      }
      const float beta = __fmul_rn(rho_s[j], gather_sum(p, ex));
      const float corr = __fsub_rn(alpha[j], beta);
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) q[k] = __fadd_rn(q[k], __fmul_rn(corr, s[k * back_stride]));
      }
    }
  }

  // d = -r; d.g and (for the first step) sum|g| in one exchange
  auto g_at = [&](int k, int i) {
    if constexpr (kRegs) return gr[k];
    else return g[i];
  };
  float pd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < walk; ++k) {
    const int i = t + k * kThreads;
    if (in_range(k)) {
      const float gi = g_at(k, i);
      const float di = -q[k];
      d[i] = di;
      pd[0] = __fadd_rn(pd[0], __fmul_rn(di, gi));
      pd[1] = __fadd_rn(pd[1], fabsf(gi));
    }
  }
  gather<2, false>(pd, ex);
  float dg = pd[0];
  const float gsum = pd[1];
  const bool guard = !(dg < 0.0f);  // not a descent direction: steepest descent
  if (guard) {
    float p = 0.0f;
#pragma unroll
    for (int k = 0; k < walk; ++k) {
      const int i = t + k * kThreads;
      if (in_range(k)) {
        const float gi = g_at(k, i);
        const float di = -gi;
        d[i] = di;
        p = __fadd_rn(p, __fmul_rn(gi, di));
      }
    }
    dg = gather_sum(p, ex);
  }
  cluster_arrive();
  // d's and x's entries: -q, or -g after the guard (the values just stored)
  auto d_at = [&](int k, int i) {
    if constexpr (kRegs) return guard ? -gr[k] : -q[k];
    else return d[i];
  };
  auto x_at = [&](int k, int i) {
    if constexpr (kRegs) return xr[k];
    else return x[i];
  };
  const float a =
      count == 0 ? min_nan(1.0f, __fdiv_rn(1.0f, max_nan(gsum, sh.f[kEpsStep]))) : 1.0f;
  if (threadIdx.x == 0) {
    int* I = sh.i;
    float* F = sh.f;
    const float f = F[kF];
    F[kDphi0] = dg;
    F[kALo] = 0.0f;
    F[kPhiLo] = f;
    F[kDphiLo] = dg;
    F[kAHi] = 0.0f;
    F[kPhiHi] = f;
    F[kAPrev] = 0.0f;
    F[kPhiPrev] = f;
    F[kDphiPrev] = dg;
    F[kATrial] = a;
    F[kABest] = 0.0f;
    F[kFBest] = f;
    I[kMode] = 0;
    I[kLsEvals] = 0;
    I[kStage] = kSearch;
    I[kNeedDir] = 0;
    if (guard) I[kBranches] |= kBrDescentGuard;
  }
#pragma unroll
  for (int k = 0; k < walk; ++k) {
    const int i = t + k * kThreads;
    if (in_range(k)) {
      gb[i] = g_at(k, i);
      xt[i] = __fadd_rn(x_at(k, i), __fmul_rn(a, d_at(k, i)));
    }
  }
  finish(sh, si, sf, ex.rank);
  cluster_wait();  // the exit's (its arrive came after the last gather)
}

// Raise, never lower, a kernel's dynamic shared memory limit (a captured
// graph keeps the size its launches were captured with).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || static_cast<size_t>(a.maxDynamicSharedSizeBytes) >= bytes) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One cluster of kCtas CTAs of kCtaThreads threads. Outside a capture
// (launch_only 0) it first sets the kernel's shared memory limit and asks
// whether such a cluster can be placed at all (kErrUnplaced if not).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), size_t smem, int launch_only, void* stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas, 1, 1);
  cfg.blockDim = dim3(kCtaThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!launch_only) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int placed = 0;
    e = cudaOccupancyMaxActiveClusters(&placed, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (placed < 1) return kErrUnplaced;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

using DirectionKernel = void (*)(int*, float*, float*, const float*, const float*, int, int);

// The instantiation for per entries a thread: q in exactly per registers up
// to kMaxPer, else in shared memory.
template <bool kResident>
DirectionKernel direction_for(int per) {
  switch (per) {
    case 1: return direction_kernel<1, kResident>;
    case 2: return direction_kernel<2, kResident>;
    case 3: return direction_kernel<3, kResident>;
    case 4: return direction_kernel<4, kResident>;
    case 5: return direction_kernel<5, kResident>;
    case 6: return direction_kernel<6, kResident>;
    case 7: return direction_kernel<7, kResident>;
    case 8: return direction_kernel<8, kResident>;
    default: return direction_kernel<0, kResident>;
  }
}

// The direction kernel's shared memory a CTA, as the wrapper's plan counts
// it: kStaticReserve and the dynamic part (direction_kernel's comment).
size_t direction_smem(int n, int m, bool resident) {
  const size_t tpb = kCtaThreads, per = (n + kThreads - 1) / kThreads, M = m;
  const size_t floats = (tpb / 32) * M + 2 * M + (per > kMaxPer ? per * tpb : 0) +
                        (resident ? 2 * M * per * tpb : 0);
  return kStaticReserve + sizeof(float) * floats;
}

}  // namespace k10
}  // namespace

using namespace k10;

extern "C" int pinns_lbfgs_slots(int* n_ints, int* n_floats, int* n_rows, int* threads) {
  *n_ints = kNumInts;
  *n_floats = kNumFloats;
  *n_rows = kRows;
  *threads = kThreads;
  return 0;
}

// The direction kernel's shared memory a CTA at (n, m, resident), as
// ops/kernels/lbfgs.py::direction_smem counts it; -1 for an empty shape.
extern "C" long long pinns_lbfgs_direction_smem(int n, int m, int resident) {
  if (n < 1 || m < 1) return -1;
  return static_cast<long long>(direction_smem(n, m, resident != 0));
}

// Every entry point launches on `stream` and returns the CUDA error code of
// its launch (0 on success; kErrUnplaced when the cluster cannot be placed).
// Pointers are device pointers of contiguous buffers the wrapper checked:
// si (kNumInts int32), sf (kNumFloats float32), vec (kRows x n float32), hist
// (2 x m x n), rho (m), x0 (n; null for the reset in place from vec's x
// row). `consts` (host) holds c1, c2, ftol, gtol,
// 1e-12, 1e-10, 1e-30, 1e8 and 1e-12 as float32. The direction kernel's
// `launch_only` (a stream capture) leaves out the shared memory limit and
// the placement check, which an earlier call with the same arguments made.
extern "C" int pinns_lbfgs_reset(void* si, void* sf, void* vec, const void* x0, int n,
                                 int max_iters, int max_ls, const float* consts, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{consts[0], consts[1], consts[2], consts[3], consts[4],
                 consts[5], consts[6], consts[7], consts[8]};
  reset_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<float*>(sf), static_cast<float*>(vec),
      static_cast<const float*>(x0), n, max_iters, max_ls, c);
  return static_cast<int>(cudaGetLastError());
}

// The control kernel on one block.
extern "C" int pinns_lbfgs_control(void* si, void* sf, void* vec, void* hist, void* rho, int n,
                                   int m, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  control_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<float*>(sf), static_cast<float*>(vec),
      static_cast<float*>(hist), static_cast<float*>(rho), n, m);
  return static_cast<int>(cudaGetLastError());
}

// The direction kernel on a cluster of 8 CTAs, the pairs resident in their
// shared memory or streamed, as the wrapper's cluster_plan chose; a plan
// whose shared memory exceeds a block's is refused.
extern "C" int pinns_lbfgs_direction(void* si, void* sf, void* vec, const void* hist,
                                     const void* rho, int n, int m, int resident,
                                     int launch_only, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = direction_smem(n, m, resident != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n + kThreads - 1) / kThreads;
  const DirectionKernel kernel = resident ? direction_for<true>(per) : direction_for<false>(per);
  return launch_cluster(kernel, smem - kStaticReserve, launch_only, stream,
                        static_cast<int*>(si), static_cast<float*>(sf), static_cast<float*>(vec),
                        static_cast<const float*>(hist), static_cast<const float*>(rho), n, m);
}

extern "C" const char* pinns_lbfgs_error_string(int code) {
  if (code == kErrUnplaced) {
    return "the card cannot place the kernel's thread block cluster "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
