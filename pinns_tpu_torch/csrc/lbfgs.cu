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
// reset_kernel writes a solve's initial state (xt = x0, stage init). Once the
// done flag is set every launch of a step reads it and returns, so a replay
// of R steps past the end costs R empty launches of each kernel.
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
// for bit (no atomics): a thread sums entries t, t + 1024, ... in turn, a
// warp's 32 sums meet in a butterfly (offsets 16, 8, 4, 2, 1), and the 32
// warps' sums in the same butterfly (block_sum). The plain versions in
// ops/kernels/lbfgs.py spell the same order, so they agree with these
// kernels bit for bit.
//
// What bounds it on the H100: latency, on one SM. Each kernel is one block
// of 1024 threads: at abgrall_admm's 8x20 (n = 3,023) the vectors are 12 KB,
// and the two-loop at a full history (m = 50) reads 1.2 MB of (s, y) pairs
// that stay in the 50 MB L2; its bound is those bytes (0.37 us at
// 3.35 TB/s), its time the 2 count dependent block reductions, about 1 us a
// step (PERF.md §6). The direction kernel holds q in registers (up to
// 8 entries a thread; shared memory beyond 8,192) and issues each step's
// loads before its reduction. The search's steps cost one to four
// reductions. A cluster that holds the history across the shared memory of
// 16 CTAs is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {
namespace k10 {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on sm_90 (227 KB)

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

struct Shared {
  int i[kNumInts];
  float f[kNumFloats];
  int t[kNumTemps];
  float f_old;
  float red[2][kWarps];
};

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

// The block's sum of every thread's v, in every thread: the lanes by a
// butterfly, the 32 warp sums by the same butterfly. One barrier; the two
// halves of red take turns, so the next reduction never writes a half that
// a thread may still read.
__device__ __forceinline__ float block_sum(float v, Shared& sh, int& turn) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sh.red[turn][threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_sum(sh.red[turn][threadIdx.x & 31]);
  turn ^= 1;
  return v;
}

__device__ __forceinline__ float block_max(float v, Shared& sh, int& turn) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) sh.red[turn][threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max(sh.red[turn][threadIdx.x & 31]);
  turn ^= 1;
  return v;
}

// This thread's part of a . b: entries t, t + kThreads, ... in turn.
__device__ __forceinline__ float dot_part(const float* a, const float* b, int n) {
  float p = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) p = __fadd_rn(p, __fmul_rn(a[i], b[i]));
  return p;
}

__device__ __forceinline__ void load_state(Shared& sh, const int* si, const float* sf) {
  if (threadIdx.x < kNumInts) sh.i[threadIdx.x] = si[threadIdx.x];
  if (threadIdx.x < kNumFloats) sh.f[threadIdx.x] = sf[threadIdx.x];
  __syncthreads();
}

__device__ __forceinline__ void store_state(const Shared& sh, int* si, float* sf) {
  __syncthreads();
  if (threadIdx.x < kNumInts) si[threadIdx.x] = sh.i[threadIdx.x];
  if (threadIdx.x < kNumFloats) sf[threadIdx.x] = sh.f[threadIdx.x];
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
  const size_t N = n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    vec[kX * N + i] = x0[i];
    vec[kXT * N + i] = x0[i];
    vec[kGT * N + i] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
control_kernel(int* si, float* sf, float* vec, float* hist, float* rho, int n, int m) {
  __shared__ Shared sh;
  load_state(sh, si, sf);
  if (sh.i[kDone]) return;
  int* I = sh.i;
  float* F = sh.f;
  int* T = sh.t;
  int turn = 0;
  const size_t N = n;
  float* x = vec + kX * N;
  float* g = vec + kG * N;
  const float* d = vec + kD * N;
  float* xt = vec + kXT * N;
  const float* gt = vec + kGT * N;
  float* gb = vec + kGB * N;

  if (I[kStage] == kInit) {  // the first evaluation: f and g at x0
    float mx = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      g[i] = gt[i];
      mx = max_nan(mx, fabsf(gt[i]));
    }
    mx = block_max(mx, sh, turn);
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
    store_state(sh, si, sf);
    return;
  }

  const float dphi = block_sum(dot_part(gt, d, n), sh, turn);
  if (threadIdx.x == 0) search_update(I, F, T, F[kPhiT], dphi);
  __syncthreads();
  if (T[kTBetter]) {
    for (int i = threadIdx.x; i < n; i += kThreads) gb[i] = gt[i];
  }
  if (!T[kTEnded]) {  // the next trial point
    const float a = F[kATrial];
    for (int i = threadIdx.x; i < n; i += kThreads) xt[i] = __fadd_rn(x[i], __fmul_rn(a, d[i]));
    store_state(sh, si, sf);
    return;
  }

  // the end of the iteration: x_new = x + a d, s = x_new - x, y = g_new - g
  const float a = F[kABest];
  float psy = 0.0f, pss = 0.0f, pyy = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float s = __fsub_rn(__fadd_rn(x[i], __fmul_rn(a, d[i])), x[i]);
    const float y = __fsub_rn(gb[i], g[i]);
    psy = __fadd_rn(psy, __fmul_rn(s, y));
    pss = __fadd_rn(pss, __fmul_rn(s, s));
    pyy = __fadd_rn(pyy, __fmul_rn(y, y));
  }
  const float sy = block_sum(psy, sh, turn);
  const float ss = block_sum(pss, sh, turn);
  const float yy = block_sum(pyy, sh, turn);
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
  float mx = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
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
  mx = block_max(mx, sh, turn);
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
  store_state(sh, si, sf);
}

// The pair j of the first loop (newest first) and of the second (oldest
// first) in the circular history.
__device__ __forceinline__ int newest(int head, int j, int m) { return ((head - 1 - j) % m + m) % m; }
__device__ __forceinline__ int oldest(int head, int count, int j, int m) {
  return ((head - count + j) % m + m) % m;
}

// The two-loop recursion, d = -r, with q (then r) in registers: a thread
// holds entries t, t + kThreads, ..., kPer of them (n <= kThreads kPer). Each step
// issues the loads of its axpy's vector and of the next step's dot vector
// before its reduction, so that their latency (L2) runs under the barrier.
// The arithmetic and its order are two_loop_shared's.
template <int kPer>
__device__ void two_loop_registers(float* d, const float* g, const float* hist, const float* rho,
                                   float* alpha, int n, int m, int count, int head, float gamma,
                                   Shared& sh, int& turn) {
  const size_t N = n;
  float q[kPer], a[kPer], b[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    q[k] = i < n ? g[i] : 0.0f;
  }
  // first loop: alpha = rho s.q, q -= alpha y; a holds s, b holds y
  if (count > 0) {
    const float* s = hist + static_cast<size_t>(newest(head, 0, m)) * N;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      a[k] = i < n ? s[i] : 0.0f;
    }
  }
  for (int j = 0; j < count; ++j) {
    const int idx = newest(head, j, m);
    const float* y = hist + (static_cast<size_t>(m) + idx) * N;
    const float* s_next = hist + static_cast<size_t>(newest(head, j + 1, m)) * N;
    float nxt[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      b[k] = i < n ? y[i] : 0.0f;
      nxt[k] = i < n && j + 1 < count ? s_next[i] : 0.0f;
    }
    float p = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (threadIdx.x + k * kThreads < n) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));
    }
    const float al = __fmul_rn(rho[idx], block_sum(p, sh, turn));
    if (threadIdx.x == 0) alpha[idx] = al;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      q[k] = __fsub_rn(q[k], __fmul_rn(al, b[k]));
      a[k] = nxt[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) q[k] = __fmul_rn(gamma, q[k]);
  // second loop: beta = rho y.r, r += (alpha - beta) s; a holds y, b holds s
  if (count > 0) {
    const float* y = hist + (static_cast<size_t>(m) + oldest(head, count, 0, m)) * N;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      a[k] = i < n ? y[i] : 0.0f;
    }
  }
  for (int j = 0; j < count; ++j) {
    const int idx = oldest(head, count, j, m);
    const float* s = hist + static_cast<size_t>(idx) * N;
    const float* y_next = hist + (static_cast<size_t>(m) + oldest(head, count, j + 1, m)) * N;
    float nxt[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      b[k] = i < n ? s[i] : 0.0f;
      nxt[k] = i < n && j + 1 < count ? y_next[i] : 0.0f;
    }
    float p = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (threadIdx.x + k * kThreads < n) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));
    }
    // alpha[idx] was written before the first loop's last barrier
    const float beta = __fmul_rn(rho[idx], block_sum(p, sh, turn));
    const float corr = __fsub_rn(alpha[idx], beta);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      q[k] = __fadd_rn(q[k], __fmul_rn(corr, b[k]));
      a[k] = nxt[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n) d[i] = -q[k];
  }
}

// The two-loop recursion for any n, q (then r) in shared memory (n floats),
// a thread its own entries: no barrier but the reductions'.
__device__ void two_loop_shared(float* d, const float* g, const float* hist, const float* rho,
                                float* alpha, float* q, int n, int m, int count, int head,
                                float gamma, Shared& sh, int& turn) {
  const size_t N = n;
  for (int i = threadIdx.x; i < n; i += kThreads) q[i] = g[i];
  for (int j = 0; j < count; ++j) {
    const int idx = newest(head, j, m);
    const float* s = hist + static_cast<size_t>(idx) * N;
    const float* y = hist + (static_cast<size_t>(m) + idx) * N;
    const float al = __fmul_rn(rho[idx], block_sum(dot_part(s, q, n), sh, turn));
    if (threadIdx.x == 0) alpha[idx] = al;
    for (int i = threadIdx.x; i < n; i += kThreads) q[i] = __fsub_rn(q[i], __fmul_rn(al, y[i]));
  }
  for (int i = threadIdx.x; i < n; i += kThreads) q[i] = __fmul_rn(gamma, q[i]);
  for (int j = 0; j < count; ++j) {
    const int idx = oldest(head, count, j, m);
    const float* s = hist + static_cast<size_t>(idx) * N;
    const float* y = hist + (static_cast<size_t>(m) + idx) * N;
    const float beta = __fmul_rn(rho[idx], block_sum(dot_part(y, q, n), sh, turn));
    const float corr = __fsub_rn(alpha[idx], beta);
    for (int i = threadIdx.x; i < n; i += kThreads) q[i] = __fadd_rn(q[i], __fmul_rn(corr, s[i]));
  }
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = -q[i];
}

// Dynamic shared memory: alpha (m floats), then, above kMaxPer x kThreads
// entries, q (n floats).
constexpr int kMaxPer = 8;

__global__ void __launch_bounds__(kThreads)
direction_kernel(int* si, float* sf, float* vec, const float* hist, const float* rho, int n,
                 int m) {
  __shared__ Shared sh;
  extern __shared__ float dyn[];
  load_state(sh, si, sf);
  if (sh.i[kDone] || !sh.i[kNeedDir]) return;
  int* I = sh.i;
  float* F = sh.f;
  int turn = 0;
  const size_t N = n;
  const float* x = vec + kX * N;
  const float* g = vec + kG * N;
  float* d = vec + kD * N;
  float* xt = vec + kXT * N;
  float* gb = vec + kGB * N;
  float* alpha = dyn;
  const int count = I[kCount], head = I[kHead];
  const float gamma = F[kGamma];
  const int per = (n + kThreads - 1) / kThreads;
  if (per <= 1) {
    two_loop_registers<1>(d, g, hist, rho, alpha, n, m, count, head, gamma, sh, turn);
  } else if (per <= 2) {
    two_loop_registers<2>(d, g, hist, rho, alpha, n, m, count, head, gamma, sh, turn);
  } else if (per <= 4) {
    two_loop_registers<4>(d, g, hist, rho, alpha, n, m, count, head, gamma, sh, turn);
  } else if (per <= kMaxPer) {
    two_loop_registers<kMaxPer>(d, g, hist, rho, alpha, n, m, count, head, gamma, sh, turn);
  } else {
    two_loop_shared(d, g, hist, rho, alpha, dyn + m, n, m, count, head, gamma, sh, turn);
  }
  float p = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) p = __fadd_rn(p, __fmul_rn(d[i], g[i]));
  float dg = block_sum(p, sh, turn);
  const bool guard = !(dg < 0.0f);  // not a descent direction: steepest descent
  if (guard) {
    p = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float di = -g[i];
      d[i] = di;
      p = __fadd_rn(p, __fmul_rn(g[i], di));
    }
    dg = block_sum(p, sh, turn);
  }
  float gsum = 0.0f;
  if (count == 0) {
    p = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) p = __fadd_rn(p, fabsf(g[i]));
    gsum = block_sum(p, sh, turn);
  }
  if (threadIdx.x == 0) {
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
    F[kATrial] =
        count == 0 ? min_nan(1.0f, __fdiv_rn(1.0f, max_nan(gsum, F[kEpsStep]))) : 1.0f;
    F[kABest] = 0.0f;
    F[kFBest] = f;
    I[kMode] = 0;
    I[kLsEvals] = 0;
    I[kStage] = kSearch;
    I[kNeedDir] = 0;
    if (guard) I[kBranches] |= kBrDescentGuard;
  }
  __syncthreads();
  const float a = F[kATrial];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    gb[i] = g[i];
    xt[i] = __fadd_rn(x[i], __fmul_rn(a, d[i]));
  }
  store_state(sh, si, sf);
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

// The largest n + m the direction kernel's shared memory holds.
extern "C" int pinns_lbfgs_max_floats() {
  return static_cast<int>((kSmemLimit - sizeof(Shared)) / sizeof(float));
}

// Every entry point launches on `stream` and returns the CUDA error code of
// its launch (0 on success). Pointers are device pointers of contiguous
// buffers the wrapper checked: si (kNumInts int32), sf (kNumFloats float32),
// vec (kRows x n float32), hist (2 x m x n), rho (m), x0 (n). `consts` (host)
// holds c1, c2, ftol, gtol, 1e-12, 1e-10, 1e-30, 1e8 and 1e-12 as float32.
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

extern "C" int pinns_lbfgs_control(void* si, void* sf, void* vec, void* hist, void* rho, int n,
                                   int m, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  control_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<float*>(sf), static_cast<float*>(vec),
      static_cast<float*>(hist), static_cast<float*>(rho), n, m);
  return static_cast<int>(cudaGetLastError());
}

// `launch_only` (a stream capture) leaves out the kernel attribute, which an
// earlier call with the same n and m set.
extern "C" int pinns_lbfgs_direction(void* si, void* sf, void* vec, const void* hist,
                                     const void* rho, int n, int m, int launch_only,
                                     void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(m) + (n > kMaxPer * kThreads ? n : 0));
  if (n < 1 || m < 1 || smem + sizeof(Shared) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!launch_only) {
    const cudaError_t e = allow_smem(direction_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  direction_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(si), static_cast<float*>(sf), static_cast<float*>(vec),
      static_cast<const float*>(hist), static_cast<const float*>(rho), n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_lbfgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
