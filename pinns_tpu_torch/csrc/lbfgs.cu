// K10, the L-BFGS solve on the device, for Hopper (sm_90a).
//
// Replaces the XLA program of pinns_tpu/opt/lbfgs.py::lbfgs_minimize (:194,
// its lax.while_loop :306) with _zoom_linesearch (:38, its loop :163) and
// _two_loop_direction (:167, its fori_loops :180 and :190). JAX runs the whole
// solve as one device program; pinns_tpu_torch/opt/lbfgs.py::lbfgs_minimize
// runs the same branches from the host, one host sync per line-search
// evaluation. Here every decision is taken on the device, so that a solve is
// a chain of *evaluation steps* that a CUDA graph runs with no host read
// between them: the body of a conditional WHILE node, the port of the
// while_loop, which the control kernel ends (ops/kernels/lbfgs.py::SolveLoop,
// for DeviceLBFGS and AutogradLBFGS). A step is
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
// and returns, so a body of k steps runs at most k - 1 empty steps after the
// end. The launch of the control kernel that sets the flag (or finds it set)
// also sets the WHILE node's condition to 0 (cudaGraphSetConditional) when it
// runs inside the loop; pinns_lbfgs_loop_* build the loop's graph around the
// captured body (a child graph) and launch it. Every launch of the control
// kernel, those after the end included, adds one to the step counter
// `steps` (one int the reset zeroes, outside the state): the steps a solve
// ran, as the device counts them, for the wrapper's counters.
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
// The float64 mode (the *_f64 entry points; `polish`, ops/kernels/lbfgs.py::
// AutogradLBFGS in float64): every kernel is a template on its scalar type,
// instantiated on float and on double. The double instantiation keeps the
// int slots, the layout and every sum's order, with the double
// round-to-nearest intrinsics (__dadd_rn, __dmul_rn, ...), 8-byte exchange
// slots (st.async .b64) and its own static reserve (SharedT<double>); its
// plain versions are the same functions in float64, so it too agrees with
// them bit for bit. Double pairs take twice the shared memory: at 8x20 (n
// about 3,000) and m = 50 they no longer fit the CTAs, so the plan streams
// them.
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
constexpr size_t kStaticReserve = 1024;    // the reserve for SharedT<float> (static_reserve)
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

// The static shared memory of a kernel working in T (float or double).
template <typename T>
struct __align__(16) SharedT {
  T red[2][kMaxSums][kWarps];      // the exchanges' slots, two turns
  unsigned long long bar[2];       // their mbarriers
  int i[kNumInts];
  T f[kNumFloats];
  int t[kNumTemps];
  T f_old;
};

// The static shared memory the plan reserves for a kernel working in T
// (ops/kernels/lbfgs.py: STATIC_SMEM by item size).
template <typename T>
constexpr size_t static_reserve() {
  return sizeof(T) == 4 ? kStaticReserve : 2 * kStaticReserve;
}
static_assert(sizeof(SharedT<float>) <= static_reserve<float>(), "Shared outgrew the reserve");
static_assert(sizeof(SharedT<double>) <= static_reserve<double>(), "Shared outgrew the reserve");

template <typename T>
struct ConstsT {
  T c1, c2, ftol, gtol, eps_dead, eps_curv, tiny, a_max, eps_step;
};

// Round-to-nearest arithmetic in T: nothing is contracted into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) { return (a < b || a != a) ? a : b; }

// A warp's butterfly (offsets 16, 8, 4, 2, 1): every lane ends with lane
// 0's sum, which is the sum in the tree w[l] + w[l + off] that the plain
// versions spell.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kMax, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  return kMax ? max_nan(a, b) : add_rn(a, b);
}

// The 32 warp sums w (shared memory, warp order) in the butterfly's tree,
// in registers: w[l] + w[l + off] for off = 16, ..., 1, lane 0's sum bit for
// bit (every lane of the butterfly holds it). Each level a loop of constant
// bounds, so that r stays in registers.
template <bool kMax, typename T>
__device__ __forceinline__ T tree32(const T* w) {
  T r[kWarps];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int l = 0; l < kWarps; l += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + l);
      r[l] = v.x;
      r[l + 1] = v.y;
      r[l + 2] = v.z;
      r[l + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kWarps; l += 2) {
      const double2 v = *reinterpret_cast<const double2*>(w + l);
      r[l] = v.x;
      r[l + 1] = v.y;
    }
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
template <typename T, bool kCluster>
struct Exchange {
  SharedT<T>* sh;
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
template <bool kCluster, typename T>
__device__ __forceinline__ Exchange<T, kCluster> exchange_begin(SharedT<T>& sh) {
  Exchange<T, kCluster> ex;
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
template <int K, bool kMax, typename T, bool kCluster>
__device__ __forceinline__ void gather(T (&v)[K], Exchange<T, kCluster>& ex) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = kMax ? warp_max(v[k]) : warp_sum(v[k]);
  SharedT<T>& sh = *ex.sh;
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
                 : "r"(bar), "r"(K * static_cast<int>(sizeof(T)) *
                                 (kWarps - static_cast<int>(blockDim.x) / 32))
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
      const uint32_t dst = map_rank(smem_addr(&sh.red[ex.turn][k][warp]), lane);
      if constexpr (sizeof(T) == 4) {
        asm volatile(
            "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                dst),
            "r"(__float_as_uint(v[k])), "r"(remote_bar)
            : "memory");
      } else {
        asm volatile(
            "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                dst),
            "l"(__double_as_longlong(v[k])), "r"(remote_bar)
            : "memory");
      }
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

template <typename T, bool kCluster>
__device__ __forceinline__ T gather_sum(T v, Exchange<T, kCluster>& ex) {
  T s[1] = {v};
  gather<1, false>(s, ex);
  return s[0];
}

template <typename T, bool kCluster>
__device__ __forceinline__ T gather_max(T v, Exchange<T, kCluster>& ex) {
  T s[1] = {v};
  gather<1, true>(s, ex);
  return s[0];
}

template <typename T>
__device__ __forceinline__ void load_state(SharedT<T>& sh, const int* si, const T* sf) {
  if (threadIdx.x < kNumInts) sh.i[threadIdx.x] = si[threadIdx.x];
  if (threadIdx.x < kNumFloats) sh.f[threadIdx.x] = sf[threadIdx.x];
  __syncthreads();
}

// Rank 0 writes the state.
template <typename T>
__device__ __forceinline__ void finish(const SharedT<T>& sh, int* si, T* sf, uint32_t rank) {
  __syncthreads();
  if (rank == 0) {
    if (threadIdx.x < kNumInts) si[threadIdx.x] = sh.i[threadIdx.x];
    if (threadIdx.x < kNumFloats) sf[threadIdx.x] = sh.f[threadIdx.x];
  }
}

// One evaluation (phi, dphi) at a = F[kATrial] into the search (thread 0):
// _zoom_linesearch's body. Sets the temps better (a new best point) and
// ended (accept or fail), and at the end ok.
template <typename R>
__device__ void search_update(int* I, R* F, int* T, R phi, R dphi) {
  const R a = F[kATrial], f0 = F[kF], dphi0 = F[kDphi0];
  const int evals = I[kLsEvals] + 1;
  I[kLsEvals] = evals;
  const bool out_of_budget = evals >= I[kMaxLs];
  const bool wolfe1 = phi <= add_rn(f0, mul_rn(mul_rn(F[kC1], a), dphi0));
  const bool wolfe2 = abs_of(dphi) <= mul_rn(-F[kC2], dphi0);
  const bool accept = wolfe1 && wolfe2;
  int br = 0;
  if (I[kMode] == 0) {  // alg. 3.5: bracket
    const bool hi_cond = !wolfe1 || (phi >= F[kPhiPrev] && evals > 1);  // zoom(a_prev, a)
    const bool to_rev = !hi_cond && dphi >= R(0);                       // zoom(a, a_prev)
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
      F[kATrial] = mul_rn(R(0.5), add_rn(F[kALo], F[kAHi]));
    } else {
      F[kATrial] = min_nan(mul_rn(R(2), a), F[kAMax]);
      br |= kBrExtend;
    }
    F[kAPrev] = a;
    F[kPhiPrev] = phi;
    F[kDphiPrev] = dphi;
  } else {  // alg. 3.6 with bisection trial points
    const bool cond_hi = !wolfe1 || phi >= F[kPhiLo];
    const bool swap = !cond_hi && mul_rn(dphi, sub_rn(F[kAHi], F[kALo])) >= R(0);
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
    F[kATrial] = mul_rn(R(0.5), add_rn(F[kALo], F[kAHi]));
  }
  const bool interval_dead =
      I[kMode] == 1 && abs_of(sub_rn(F[kAHi], F[kALo])) <=
                           mul_rn(F[kEpsDead], max_nan(R(1), abs_of(F[kAHi])));
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

template <typename R>
__global__ void reset_kernel(int* si, R* sf, R* vec, int* steps, const R* x0, int n,
                             int max_iters, int max_ls, ConstsT<R> c) {
  if (threadIdx.x == 0) {
    *steps = 0;
    for (int k = 0; k < kNumInts; ++k) si[k] = 0;
    for (int k = 0; k < kNumFloats; ++k) sf[k] = R(0);
    si[kStage] = kInit;
    si[kMaxIters] = max_iters;
    si[kMaxLs] = max_ls;
    sf[kGamma] = R(1);
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
  const R* src = x0 != nullptr ? x0 : vec + kX * N;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const R v = src[i];
    if (x0 != nullptr) vec[kX * N + i] = v;
    vec[kXT * N + i] = v;
    vec[kGT * N + i] = R(0);
  }
}

// The solve's WHILE node (ops/kernels/lbfgs.py::SolveLoop): the control
// launch that sets the done flag, or finds it set, sets the node's condition
// to 0, so the loop ends after the body iteration that holds it. `looped` 0
// (a launch outside such a node: the stepwise drive, the checks): nothing.
template <typename T>
__device__ __forceinline__ void end_loop_if_done(const SharedT<T>& sh,
                                                 cudaGraphConditionalHandle cond, int looped) {
  if (looped && threadIdx.x == 0 && sh.i[kDone]) cudaGraphSetConditional(cond, 0);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
control_kernel(int* si, R* sf, R* vec, R* hist, R* rho, int* steps, int n, int m,
               cudaGraphConditionalHandle cond, int looped) {
  __shared__ SharedT<R> sh;
  if (threadIdx.x == 0) *steps += 1;  // every launch, after the end too
  const int t = virtual_thread();
  const size_t N = n;
  R* x = vec + kX * N;
  R* g = vec + kG * N;
  const R* d = vec + kD * N;
  R* xt = vec + kXT * N;
  const R* gt = vec + kGT * N;
  R* gb = vec + kGB * N;
  // this thread's parts of phi' = gt . d and of max|gt|, read beside the
  // state (the first evaluation takes the maximum, every other the dot)
  R part = R(0), mx = R(0);
  for (int i = t; i < n; i += kThreads) {
    part = add_rn(part, mul_rn(gt[i], d[i]));
    mx = max_nan(mx, abs_of(gt[i]));
  }
  load_state(sh, si, sf);
  if (sh.i[kDone]) {
    end_loop_if_done(sh, cond, looped);
    return;
  }
  auto ex = exchange_begin<false>(sh);
  int* I = sh.i;
  R* F = sh.f;
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
    end_loop_if_done(sh, cond, looped);
    return;
  }

  const R dphi = gather_sum(part, ex);
  if (threadIdx.x == 0) search_update(I, F, T, F[kPhiT], dphi);
  __syncthreads();
  if (T[kTBetter]) {
    for (int i = t; i < n; i += kThreads) gb[i] = gt[i];
  }
  if (!T[kTEnded]) {  // the next trial point
    const R a = F[kATrial];
    for (int i = t; i < n; i += kThreads) xt[i] = add_rn(x[i], mul_rn(a, d[i]));
    finish(sh, si, sf, 0);
    return;
  }

  // the end of the iteration: x_new = x + a d, s = x_new - x, y = g_new - g;
  // s.y, s.s and y.y in one exchange, each in its own tree
  const R a = F[kABest];
  R p[3] = {R(0), R(0), R(0)};
  for (int i = t; i < n; i += kThreads) {
    const R s = sub_rn(add_rn(x[i], mul_rn(a, d[i])), x[i]);
    const R y = sub_rn(gb[i], g[i]);
    p[0] = add_rn(p[0], mul_rn(s, y));
    p[1] = add_rn(p[1], mul_rn(s, s));
    p[2] = add_rn(p[2], mul_rn(y, y));
  }
  gather<3, false>(p, ex);
  const R sy = p[0], ss = p[1], yy = p[2];
  if (threadIdx.x == 0) {
    const bool ok = T[kTOk];
    const R ns = sqrt_rn(ss), ny = sqrt_rn(yy);
    const bool store = ok && sy > mul_rn(mul_rn(F[kEpsCurv], ns), ny);
    T[kTStore] = store;
    T[kTOldHead] = I[kHead];
    if (store) {
      rho[I[kHead]] = div_rn(R(1), max_nan(sy, F[kTiny]));
      I[kHead] = (I[kHead] + 1) % m;
      I[kCount] = I[kCount] + 1 < m ? I[kCount] + 1 : m;
      F[kGamma] = div_rn(sy, max_nan(yy, F[kTiny]));
      I[kBranches] |= kBrStored;
    } else if (ok) {
      I[kBranches] |= kBrCurvSkip;
    }
    sh.f_old = F[kF];
    if (ok) F[kF] = F[kFBest];
  }
  __syncthreads();
  const bool ok = T[kTOk], store = T[kTStore];
  R* hs = hist + static_cast<size_t>(T[kTOldHead]) * N;
  R* hy = hist + (static_cast<size_t>(m) + T[kTOldHead]) * N;
  mx = R(0);
  for (int i = t; i < n; i += kThreads) {
    const R xn = add_rn(x[i], mul_rn(a, d[i]));
    if (store) {
      hs[i] = sub_rn(xn, x[i]);
      hy[i] = sub_rn(gb[i], g[i]);
    }
    if (ok) {
      x[i] = xn;
      g[i] = gb[i];
    }
    mx = max_nan(mx, abs_of(g[i]));
  }
  mx = gather_max(mx, ex);
  if (threadIdx.x == 0) {  // SciPy's stopping rules
    const R f_old = sh.f_old, f = F[kF];
    const bool g_small = mx <= F[kGtol];
    const bool f_flat =
        ok && sub_rn(f_old, f) <=
                  mul_rn(F[kFtol], max_nan(max_nan(abs_of(f_old), abs_of(f)), R(1)));
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
  end_loop_if_done(sh, cond, looped);
}

// The pair j of the first loop (newest first) in the circular history; the
// second loop walks the same slots back (j = count - 1, ..., 0).
__device__ __forceinline__ int newest(int head, int j, int m) { return ((head - 1 - j) % m + m) % m; }

// q (then r) of this thread: kPer entries in registers, or (kPer = 0) its
// per entries in shared memory, entry k at s[k * blockDim.x].
template <typename R, int kPer>
struct QVec {
  R r[kPer];
  __device__ __forceinline__ R& operator[](int k) { return r[k]; }
};
template <typename R>
struct QVec<R, 0> {
  R* s;
  __device__ __forceinline__ R& operator[](int k) { return s[k * blockDim.x]; }
};

// The direction kernel: one cluster of kCtas = 8 CTAs of 128 threads, the
// virtual block's thread t owning entries t, t + 1024, ...
// (per of them). kPer: q in registers (1, 2, 4, 8 entries) or in shared
// memory (0). The first loop reads each pair from global memory (L2), the
// next step's dot vector loaded before each exchange; kResident: it also
// stores this thread's entries into the CTA's shared memory, from which the
// second loop reads them (else from global memory again, the streamed
// design). Dynamic shared memory, in Rs: alpha (a row of m for each
// warp: its lane 0 writes, its lanes read), rho of the count newest pairs
// (m), their slots in the circular history (m ints), q when kPer = 0 (per x
// blockDim.x), the resident pairs (slot j's s, then its y, each per x
// blockDim.x, m slots).
template <typename R, int kPer, bool kResident>
__global__ void __launch_bounds__(kCtaThreads)
direction_kernel(int* si, R* sf, R* vec, const R* hist, const R* rho, int n,
                 int m) {
  __shared__ SharedT<R> sh;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  R* dyn = reinterpret_cast<R*>(dyn_raw);
  constexpr bool kRegs = kPer > 0;
  const int tpb = blockDim.x, tid = threadIdx.x, t = virtual_thread();
  const size_t N = n;
  const R* x = vec + kX * N;
  const R* g = vec + kG * N;
  R* d = vec + kD * N;
  R* xt = vec + kXT * N;
  R* gb = vec + kGB * N;
  QVec<R, kPer> q;
  // g's and x's entries (registers), read beside the state
  R gr[kRegs ? kPer : 1], xr[kRegs ? kPer : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + k * kThreads;
      gr[k] = i < n ? g[i] : R(0);
      xr[k] = i < n ? x[i] : R(0);
      q[k] = gr[k];
    }
  }
  load_state(sh, si, sf);
  if (sh.i[kDone] || !sh.i[kNeedDir]) return;
  const int count = sh.i[kCount], head = sh.i[kHead];
  const R gamma = sh.f[kGamma];
  const int per = (n + kThreads - 1) / kThreads;
  const int walk = kRegs ? kPer : per;  // the entries a thread walks
  // entry k of this thread exists: always below the last (kPer is per)
  auto in_range = [&](int k) { return (kRegs && k < kPer - 1) || t + k * kThreads < n; };
  R* alpha = dyn + (tid >> 5) * m;
  R* rho_s = dyn + (tpb >> 5) * m;
  int* slot = reinterpret_cast<int*>(rho_s + m);
  R* qs = rho_s + 2 * m;
  R* hs = qs + (kRegs ? 0 : per * tpb);
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
      q[k] = i < n ? g[i] : R(0);
    }
  }
  cluster_wait();  // every CTA's barriers initialised

  // this thread's entries of slot j's s (which 0) or y (which 1): in global
  // memory (entry k at [k * kThreads]) and, resident, in the CTA's copy
  // (entry k at [k * tpb]); the second loop reads them at `back`
  auto global_row = [&](int j, int which) -> const R* {
    return hist + (static_cast<size_t>(which) * m + slot[j]) * N + t;
  };
  auto copy_row = [&](int j, int which) -> R* {
    return hs + static_cast<size_t>(2 * j + which) * per * tpb + tid;
  };
  auto back = [&](int j, int which) -> const R* {
    if (kResident) return copy_row(j, which);
    return global_row(j, which);
  };
  const int back_stride = kResident ? tpb : kThreads;

  if constexpr (kRegs) {
    // first loop, newest first: alpha = rho s.q, q -= alpha y; the step's
    // dot vector a was loaded a step ahead
    R a[kPer];
    if (count > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[k] = in_range(k) ? global_row(0, 0)[k * kThreads] : R(0);
      }
    }
    for (int j = 0; j < count; ++j) {
      const R* y = global_row(j, 1);
      R b[kPer], nxt[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool valid = in_range(k);
        b[k] = valid ? y[k * kThreads] : R(0);
        nxt[k] = valid && j + 1 < count ? global_row(j + 1, 0)[k * kThreads] : R(0);
      }
      R p = R(0);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (in_range(k)) p = add_rn(p, mul_rn(a[k], q[k]));
      }
      const R al = mul_rn(rho_s[j], gather_sum(p, ex));
      if ((tid & 31) == 0) alpha[j] = al;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        q[k] = sub_rn(q[k], mul_rn(al, b[k]));
        if (kResident && k < per) {  // the copy holds per entries a thread
          copy_row(j, 0)[k * tpb] = a[k];
          copy_row(j, 1)[k * tpb] = b[k];
        }
        a[k] = nxt[k];
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPer; ++k) q[k] = mul_rn(gamma, q[k]);
    // second loop, oldest first: beta = rho y.r, r += (alpha - beta) s
    if (count > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[k] = in_range(k) ? back(count - 1, 1)[k * back_stride] : R(0);
      }
    }
    for (int j = count - 1; j >= 0; --j) {
      const R* s = back(j, 0);
      R b[kPer], nxt[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool valid = in_range(k);
        b[k] = valid ? s[k * back_stride] : R(0);
        nxt[k] = valid && j > 0 ? back(j - 1, 1)[k * back_stride] : R(0);
      }
      R p = R(0);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (in_range(k)) p = add_rn(p, mul_rn(a[k], q[k]));
      }
      const R beta = mul_rn(rho_s[j], gather_sum(p, ex));
      const R corr = sub_rn(alpha[j], beta);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        q[k] = add_rn(q[k], mul_rn(corr, b[k]));
        a[k] = nxt[k];
      }
    }
  } else {
    for (int j = 0; j < count; ++j) {
      const R* s = global_row(j, 0);
      const R* y = global_row(j, 1);
      R p = R(0);
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) {
          const R sk = s[k * kThreads];
          if (kResident) copy_row(j, 0)[k * tpb] = sk;
          p = add_rn(p, mul_rn(sk, q[k]));
        }
      }
      const R al = mul_rn(rho_s[j], gather_sum(p, ex));
      if ((tid & 31) == 0) alpha[j] = al;
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) {
          const R yk = y[k * kThreads];
          if (kResident) copy_row(j, 1)[k * tpb] = yk;
          q[k] = sub_rn(q[k], mul_rn(al, yk));
        }
      }
    }
    __syncwarp();
    for (int k = 0; k < per; ++k) q[k] = mul_rn(gamma, q[k]);
    for (int j = count - 1; j >= 0; --j) {
      const R* y = back(j, 1);
      const R* s = back(j, 0);
      R p = R(0);
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) p = add_rn(p, mul_rn(y[k * back_stride], q[k]));
      }
      const R beta = mul_rn(rho_s[j], gather_sum(p, ex));
      const R corr = sub_rn(alpha[j], beta);
      for (int k = 0; k < per; ++k) {
        if (in_range(k)) q[k] = add_rn(q[k], mul_rn(corr, s[k * back_stride]));
      }
    }
  }

  // d = -r; d.g and (for the first step) sum|g| in one exchange
  auto g_at = [&](int k, int i) {
    if constexpr (kRegs) return gr[k];
    else return g[i];
  };
  R pd[2] = {R(0), R(0)};
#pragma unroll
  for (int k = 0; k < walk; ++k) {
    const int i = t + k * kThreads;
    if (in_range(k)) {
      const R gi = g_at(k, i);
      const R di = -q[k];
      d[i] = di;
      pd[0] = add_rn(pd[0], mul_rn(di, gi));
      pd[1] = add_rn(pd[1], abs_of(gi));
    }
  }
  gather<2, false>(pd, ex);
  R dg = pd[0];
  const R gsum = pd[1];
  const bool guard = !(dg < R(0));  // not a descent direction: steepest descent
  if (guard) {
    R p = R(0);
#pragma unroll
    for (int k = 0; k < walk; ++k) {
      const int i = t + k * kThreads;
      if (in_range(k)) {
        const R gi = g_at(k, i);
        const R di = -gi;
        d[i] = di;
        p = add_rn(p, mul_rn(gi, di));
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
  const R a =
      count == 0 ? min_nan(R(1), div_rn(R(1), max_nan(gsum, sh.f[kEpsStep]))) : R(1);
  if (threadIdx.x == 0) {
    int* I = sh.i;
    R* F = sh.f;
    const R f = F[kF];
    F[kDphi0] = dg;
    F[kALo] = R(0);
    F[kPhiLo] = f;
    F[kDphiLo] = dg;
    F[kAHi] = R(0);
    F[kPhiHi] = f;
    F[kAPrev] = R(0);
    F[kPhiPrev] = f;
    F[kDphiPrev] = dg;
    F[kATrial] = a;
    F[kABest] = R(0);
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
      xt[i] = add_rn(x_at(k, i), mul_rn(a, d_at(k, i)));
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

template <typename R>
using DirectionKernel = void (*)(int*, R*, R*, const R*, const R*, int, int);

// The instantiation for per entries a thread: q in exactly per registers up
// to kMaxPer, else in shared memory.
template <typename R, bool kResident>
DirectionKernel<R> direction_for(int per) {
  switch (per) {
    case 1: return direction_kernel<R, 1, kResident>;
    case 2: return direction_kernel<R, 2, kResident>;
    case 3: return direction_kernel<R, 3, kResident>;
    case 4: return direction_kernel<R, 4, kResident>;
    case 5: return direction_kernel<R, 5, kResident>;
    case 6: return direction_kernel<R, 6, kResident>;
    case 7: return direction_kernel<R, 7, kResident>;
    case 8: return direction_kernel<R, 8, kResident>;
    default: return direction_kernel<R, 0, kResident>;
  }
}

// The direction kernel's shared memory a CTA, as the wrapper's plan counts
// it: the static reserve and the dynamic part (direction_kernel's comment),
// in words of R.
template <typename R>
size_t direction_smem(int n, int m, bool resident) {
  const size_t tpb = kCtaThreads, per = (n + kThreads - 1) / kThreads, M = m;
  const size_t words = (tpb / 32) * M + 2 * M + (per > kMaxPer ? per * tpb : 0) +
                       (resident ? 2 * M * per * tpb : 0);
  return static_reserve<R>() + sizeof(R) * words;
}

template <typename R>
int reset(void* si, void* sf, void* vec, void* steps, const void* x0, int n, int max_iters,
          int max_ls, const R* consts, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ConstsT<R> c{consts[0], consts[1], consts[2], consts[3], consts[4],
                     consts[5], consts[6], consts[7], consts[8]};
  reset_kernel<R><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<R*>(sf), static_cast<R*>(vec),
      static_cast<int*>(steps), static_cast<const R*>(x0), n, max_iters, max_ls, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int control(void* si, void* sf, void* vec, void* hist, void* rho, void* steps, int n, int m,
            unsigned long long cond, int looped, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  control_kernel<R><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<R*>(sf), static_cast<R*>(vec), static_cast<R*>(hist),
      static_cast<R*>(rho), static_cast<int*>(steps), n, m,
      static_cast<cudaGraphConditionalHandle>(cond), looped);
  return static_cast<int>(cudaGetLastError());
}

// A solve's loop: a graph of one conditional WHILE node, its condition
// created with a default of 1 that every launch reassigns, its body the
// captured steps (a child graph) that the control kernel ends.
struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;  // the node's body graph (owned by the node)
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle cond = 0;
};

void destroy(Loop* loop) {
  if (loop->exec != nullptr) cudaGraphExecDestroy(loop->exec);
  if (loop->graph != nullptr) cudaGraphDestroy(loop->graph);
  delete loop;
}

template <typename R>
int direction(void* si, void* sf, void* vec, const void* hist, const void* rho, int n, int m,
              int resident, int launch_only, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = direction_smem<R>(n, m, resident != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n + kThreads - 1) / kThreads;
  const DirectionKernel<R> kernel =
      resident ? direction_for<R, true>(per) : direction_for<R, false>(per);
  return launch_cluster(kernel, smem - static_reserve<R>(), launch_only, stream,
                        static_cast<int*>(si), static_cast<R*>(sf), static_cast<R*>(vec),
                        static_cast<const R*>(hist), static_cast<const R*>(rho), n, m);
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
  return static_cast<long long>(direction_smem<float>(n, m, resident != 0));
}

// The same in the float64 mode.
extern "C" long long pinns_lbfgs_direction_smem_f64(int n, int m, int resident) {
  if (n < 1 || m < 1) return -1;
  return static_cast<long long>(direction_smem<double>(n, m, resident != 0));
}

// Every entry point launches on `stream` and returns the CUDA error code of
// its launch (0 on success; kErrUnplaced when the cluster cannot be placed).
// Pointers are device pointers of contiguous buffers the wrapper checked:
// si (kNumInts int32), sf (kNumFloats float32), vec (kRows x n float32), hist
// (2 x m x n), rho (m), steps (one int32: the step counter), x0 (n; null for
// the reset in place from vec's x row). `consts` (host) holds c1, c2, ftol, gtol,
// 1e-12, 1e-10, 1e-30, 1e8 and 1e-12 as float32. The direction kernel's
// `launch_only` (a stream capture) leaves out the shared memory limit and
// the placement check, which an earlier call with the same arguments made.
// The *_f64 entry points are the float64 mode: sf, vec, hist, rho, x0 and
// `consts` in double, the same kernels instantiated on double (every sum in
// the same order, with the double round-to-nearest intrinsics).
extern "C" int pinns_lbfgs_reset(void* si, void* sf, void* vec, void* steps, const void* x0,
                                 int n, int max_iters, int max_ls, const float* consts,
                                 void* stream) {
  return reset<float>(si, sf, vec, steps, x0, n, max_iters, max_ls, consts, stream);
}

extern "C" int pinns_lbfgs_reset_f64(void* si, void* sf, void* vec, void* steps, const void* x0,
                                     int n, int max_iters, int max_ls, const double* consts,
                                     void* stream) {
  return reset<double>(si, sf, vec, steps, x0, n, max_iters, max_ls, consts, stream);
}

// The control kernel on one block. With `looped` 1 it sets the condition
// `cond` of the WHILE node that runs it to 0 once the done flag is set (a
// launch captured into SolveLoop's body); with 0 `cond` is not read.
extern "C" int pinns_lbfgs_control(void* si, void* sf, void* vec, void* hist, void* rho,
                                   void* steps, int n, int m, unsigned long long cond, int looped,
                                   void* stream) {
  return control<float>(si, sf, vec, hist, rho, steps, n, m, cond, looped, stream);
}

extern "C" int pinns_lbfgs_control_f64(void* si, void* sf, void* vec, void* hist, void* rho,
                                       void* steps, int n, int m, unsigned long long cond,
                                       int looped, void* stream) {
  return control<double>(si, sf, vec, hist, rho, steps, n, m, cond, looped, stream);
}

// A new loop on the current device: its graph, the WHILE node and its
// condition (written to *cond, for the control launches of the body). The
// body is added by pinns_lbfgs_loop_body.
extern "C" int pinns_lbfgs_loop_create(void** loop_out, unsigned long long* cond) {
  Loop* loop = new Loop();
  cudaError_t e = cudaGraphCreate(&loop->graph, 0);
  if (e == cudaSuccess) {
    e = cudaGraphConditionalHandleCreate(&loop->cond, loop->graph, 1,
                                         cudaGraphCondAssignDefault);
  }
  if (e == cudaSuccess) {
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = loop->cond;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, loop->graph, nullptr, 0, &params);
    if (e == cudaSuccess) loop->body = params.conditional.phGraph_out[0];
  }
  if (e != cudaSuccess) {
    destroy(loop);
    return static_cast<int>(e);
  }
  *loop_out = loop;
  *cond = static_cast<unsigned long long>(loop->cond);
  return 0;
}

// The body: a copy of the captured graph `steps` (a cudaGraph_t the caller
// keeps or frees) as the WHILE node's child, then the loop instantiated.
extern "C" int pinns_lbfgs_loop_body(void* loop_ptr, void* steps) {
  Loop* loop = static_cast<Loop*>(loop_ptr);
  if (loop->exec != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraphNode_t child;
  cudaError_t e =
      cudaGraphAddChildGraphNode(&child, loop->body, nullptr, 0, static_cast<cudaGraph_t>(steps));
  if (e == cudaSuccess) e = cudaGraphInstantiate(&loop->exec, loop->graph, 0);
  return static_cast<int>(e);
}

// One launch of the loop on `stream`: the body runs until a control launch
// ends it.
extern "C" int pinns_lbfgs_loop_launch(void* loop_ptr, void* stream) {
  Loop* loop = static_cast<Loop*>(loop_ptr);
  if (loop->exec == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(loop->exec, static_cast<cudaStream_t>(stream)));
}

extern "C" int pinns_lbfgs_loop_destroy(void* loop_ptr) {
  destroy(static_cast<Loop*>(loop_ptr));
  return 0;
}

// The direction kernel on a cluster of 8 CTAs, the pairs resident in their
// shared memory or streamed, as the wrapper's cluster_plan chose; a plan
// whose shared memory exceeds a block's is refused.
extern "C" int pinns_lbfgs_direction(void* si, void* sf, void* vec, const void* hist,
                                     const void* rho, int n, int m, int resident,
                                     int launch_only, void* stream) {
  return direction<float>(si, sf, vec, hist, rho, n, m, resident, launch_only, stream);
}

extern "C" int pinns_lbfgs_direction_f64(void* si, void* sf, void* vec, const void* hist,
                                         const void* rho, int n, int m, int resident,
                                         int launch_only, void* stream) {
  return direction<double>(si, sf, vec, hist, rho, n, m, resident, launch_only, stream);
}

extern "C" const char* pinns_lbfgs_error_string(int code) {
  if (code == kErrUnplaced) {
    return "the card cannot place the kernel's thread block cluster "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
