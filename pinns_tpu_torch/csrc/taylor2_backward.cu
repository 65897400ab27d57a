// Backward of the fused Taylor-2 pass (K1, csrc/taylor2.cu), for Hopper
// (sm_90a): the cotangents of the four streams (u, u_x, u_t, u_xx) -> dW, db
// of every layer.
//
// The TPU package had no kernel for it: its custom-VJP op recomputed the
// Taylor pass in XLA and took the VJP there (pinns_tpu/ops/pallas/
// fused_mlp.py at git 89afc4b^, lines 391-418). The port needs it on the card
// to differentiate the residual of the training loss outside the fused Adam
// step (the L-BFGS phase, the generic Adam step, burgers_scale's
// microbatches). The algorithm is the reverse mode the fused step writes out
// (header of csrc/fused_step.cu): for a hidden layer with s = tanh p,
// s' = 1 - s^2, s'' = -2 s s' and output adjoints (gh, ghx, ght, ghxx):
//   gpxx = ghxx s'              gpx = ghx s' + 2 ghxx s'' px
//   gpt  = ght s'               gp  = s' (gh - 2 s (ghx px + ght pt + ghxx pxx)
//                                         + (6 s^2 - 2) ghxx px^2)
// dW = sum over points and streams of H_in^T gP, db = sum of gp, and the
// input adjoints are gP W^T. Here the head is seeded with the given stream
// cotangents. ops/kernels/taylor2.py::taylor2_backward_reference is this
// algorithm in plain PyTorch, held against torch.autograd by the CPU tests.
//
// Design: the whole call, layer by layer, as dense products over all its
// points. For each layer the four streams are stacked stream-major into one
// row-major (4 Np x width) matrix: rows [s Np, (s + 1) Np) hold stream s
// (value, x, t, xx) of the points 0..Np-1, where Np is N padded up to the
// products' row tile, so that no tile straddles two streams. Padded points
// take the streams of the point (0, 0) and a zero cotangent. Every stacked
// input H carries one more column, 1 on value rows and 0 elsewhere, so that
// the flat parameters [W_l; b_l] (b_l follows W_l in pack_params order) are
// one (din + 1) x dout matrix: P = H [W; b] adds the bias to value rows only.
//   forward   P_l = H_l [W_l; b_l] (NN product), then an elementwise pass
//             that rounds P_l in place under the policy, keeps it (the only
//             thing stored per layer: 4 Np x dout floats), and writes H_l+1
//             by the tanh Taylor rule;
//   backward  head first, with G the adjoints of layer l's pre-activation
//             streams (the cotangents at the head) and H_l its inputs:
//               one launch of two products, dW_l = H_l^T G (TN, split over
//               row chunks of at most 1,024 rows into per-split partials: a
//               float32 chain that long stays within cuBLAS's accuracy) and
//               gH = G W_l^T (NT);
//               an elementwise pass that turns gH into the adjoints of
//               layer l-1's pre-activations (the formulas above, at P_l-1),
//               sums their value rows per tile of points in double (db_l-1:
//               a sum over points that may cancel, where a float32 chain
//               would lose to autograd's pairwise sums), and recomputes
//               H_l-1 from P_l-2 for the next layer's dW;
//   reduce    one thread per parameter, in double: a weight's partials, a
//             bias's per-tile sums, each in a fixed order.
// Every launch goes on the caller's stream, from one host call (36 launches
// at 9 layers); no atomics, so two calls agree bit for bit. The caller
// allocates the scratch, one buffer that the launcher lays out and checks
// against its size.
//
// The products share one SIMT tile routine (gemm_tile): a block computes a
// 128 x 128 tile with 256 threads; each thread keeps an 8 x 8 register tile,
// so a float loaded from shared memory feeds 8 FMAs. Tiles of A and B (8
// deep) stream through three shared-memory stages filled by cp.async, zero
// past the edges: 16-byte copies where the operand runs along the tile's
// rows in memory (both operands of dW = H^T G, whose H rows are padded to
// 16 bytes, and the weights of the forward's products), single floats
// elsewhere (any width, any leading dimension). A warp owns a 32 x 64
// sub-tile and skips the FMAs of the rows and columns that lie past the
// matrix by halves: at
// width 200 a 128-column tile computes 224 columns, not 256, and dW's 200 x
// 200 computes 208 x 224. Products stay float32 FMA: TF32 is barred by the
// numerics rule, and the cotangents are float32.
//
// The same launcher, instantiated with kMixed, is the backward of K6 (csrc/
// taylor2.cu under the bf16 stream policy): the forward is recomputed with
// K6's rounding (policy_act and rq of taylor2_policy.cuh, the same code as
// K6's), the stored streams are the bf16-rounded ones, each quantized
// stream's row tiles of the NN and NT products read a bf16-rounded copy of
// the weights (biases unrounded), made once a call, and the tanh factors
// s, s', s'' are the forward's rounded ones. The casts count as identity and
// every cotangent stays float32. This differs from torch.autograd through
// the plain mixed recurrence, which rounds the cotangents of bf16 tensors to
// bf16; JAX's op for the TPU kernel took the VJP of its XLA recompute, which
// rounds as autograd does.
//
// What bounds it on the H100: the operations. At 8x200 and one 8,192-point
// microbatch of burgers_scale the three products of a layer are each
// 32,768 x 200 x 200 (55 GFLOP a call, 823 us at 67 TFLOP/s fp32); the
// elementwise passes move about 1.3 GB (0.4 ms at 3.35 TB/s). Measured on an
// H100 at 700 W (PERF.md, Findings): the products at 37-41% of the fp32
// peak. At 8x20 and a few thousand points, the 36 launches' host cost.

#include <cuda_runtime.h>
#include <stddef.h>

#include "taylor2_policy.cuh"

namespace {

constexpr int kMaxLayers = 32;
// The products: 256 threads a block, each an 8 x 8 register tile; a warp's
// lanes are 4 x 8 threads (a 32 x 64 sub-tile), the block's warps 4 x 2
// (kBM = 128 rows x kBN = 128 columns). Tiles of A and B, kDepth deep,
// stream through kStages shared-memory stages.
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kDepth = 8;
constexpr int kStages = 3;
constexpr int kTile = 128;  // the row tile of the elementwise passes and of db's sums
constexpr int kGemmThreads = 256;
constexpr int kEwThreads = 256;
constexpr int kEwMaxBlocks = 132 * 16;

// The row pitch of a stacked input H of width d: its d streams' columns, the
// bias's indicator, then up to 3 unused floats, so that every row starts on
// 16 bytes and dW's product reads H^T in 16-byte copies.
__host__ __device__ constexpr int ld_h(int d) { return (d + 4) / 4 * 4; }

struct Net {
  int n_layers;
  int max_width;
  int n_params;
  int dims[kMaxLayers + 1];
  int w_off[kMaxLayers];  // offsets of W_l (din x dout, row-major) in the flat params
  int b_off[kMaxLayers];  // offsets of b_l (dout), = w_off[l] + din * dout
};

struct Box {
  float lb0, lb1, ub0, ub1;
};

// C (M x N) = A (M x K) B (K x N), row-major C with leading dimension ldc.
// A(m, k) = kATrans ? A[k lda + m] : A[m lda + k]; B(k, n) likewise. Split z
// (blockIdx.z) sums k in [z k_split, min(K, (z + 1) k_split)) into
// C + z c_split. A row tile starting at m0 lies in stream m0 / n_pad and
// takes Bq in place of B where bit (m0 / n_pad) of qmask is set.
struct Gemm {
  const float* A;
  const float* B;
  const float* Bq;
  float* C;
  int lda, ldb, ldc;
  int M, N, K, k_split;
  long long c_split;
  int n_pad, qmask;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}

// 16 bytes, of which the first `bytes` (0 to 16) are read and the rest zero;
// both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A thread's share of the copies of one operand, X(r, k) = kContig ?
// X[k ld + r] : X[r ld + k], into S[k][r] for a tile of kRows rows from r0
// and kDepth of depth, zero past the matrix's rows and past k1. Where X runs
// along the tile's rows in memory (kContig) from a 16-byte aligned start
// with ld a multiple of 4, a thread copies 4 rows at one depth with one
// 16-byte cp.async (kRows kDepth = 4 x 256 floats a tile); elsewhere it
// copies kRows kDepth / 256 single floats at fixed places in the tile, the
// threads of a warp walking the dimension that is contiguous in memory.
// Offsets are 32-bit (the launcher keeps every operand below 2^31 floats)
// and computed once, so a copy costs an add.
template <bool kContig, int kRows>
struct TileLoader {
  static constexpr int kLoads = kRows * kDepth / kGemmThreads;
  static constexpr int kDr = kContig ? 0 : kGemmThreads / kDepth;  // row step between elements
  static constexpr int kDk = kContig ? kGemmThreads / kRows : 0;   // depth step
  static_assert(kRows * kDepth == 4 * kGemmThreads, "one 16-byte copy a thread");
  const float* X;
  int r, k;       // the first element's place in the tile
  int base;       // its offset at depth 0
  int step;       // the offset between elements
  int kstep;      // the offset of one unit of depth
  int rows_ok;    // bit i: element i's row lies inside the matrix
  int vec_bytes;  // 16-byte copies: the bytes of the thread's 4 rows inside the matrix; else -1

  __device__ TileLoader(const float* X_, int ld, int r0, int rows) : X(X_) {
    const bool vec = kContig && ld % 4 == 0 && (reinterpret_cast<size_t>(X_) & 15) == 0;
    if (vec) {
      r = threadIdx.x % (kRows / 4) * 4;
      k = threadIdx.x / (kRows / 4);
      const int left = rows - r0 - r;
      vec_bytes = 4 * (left < 0 ? 0 : (left < 4 ? left : 4));
    } else {
      r = kContig ? threadIdx.x % kRows : threadIdx.x / kDepth;
      k = kContig ? threadIdx.x / kRows : threadIdx.x % kDepth;
      vec_bytes = -1;
    }
    base = kContig ? k * ld + r0 + r : (r0 + r) * ld + k;
    step = kContig ? kDk * ld : kDr * ld;
    kstep = kContig ? ld : 1;
    rows_ok = 0;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) rows_ok |= (r0 + r + i * kDr < rows ? 1 : 0) << i;
  }

  __device__ __forceinline__ void load(float (*S)[kRows + 4], int k0, int k1) const {
    const int at = base + k0 * kstep;
    if (kContig && vec_bytes >= 0) {
      const bool ok = vec_bytes > 0 && k0 + k < k1;
      cp_async16(&S[k][r], ok ? X + at : X, ok ? vec_bytes : 0);
      return;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const bool ok = ((rows_ok >> i) & 1) != 0 && k0 + k + i * kDk < k1;
      cp_async4(&S[k + i * kDk][r + i * kDr], ok ? X + at + i * step : X, ok);
    }
  }
};

// The stages of A and B tiles (rows padded by 4 floats: the cp.async stores
// of a warp hit distinct banks), filled kStages - 1 tiles ahead of the FMAs,
// one barrier per tile.
struct Ring {
  float A[kStages][kDepth][kBM + 4];
  float B[kStages][kDepth][kBN + 4];
};

// One stage's FMAs into a thread's 8 x 8 tile: its first kRows rows and kCols
// columns (4 or 8 each; the rest lie past the matrix for the whole warp).
template <int kRows, int kCols>
__device__ __forceinline__ void fma_tile(float (*As)[kBM + 4], float (*Bs)[kBN + 4], int r0,
                                         int c0, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&As[k][r0 + 16 * q]);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&Bs[k][c0 + 32 * q]);
      b[4 * q] = v.x;
      b[4 * q + 1] = v.y;
      b[4 * q + 2] = v.z;
      b[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Tile (bx, by) of split bz of the product g, by the whole block.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int bx, int by, int bz, Ring& ring) {
  auto& As = ring.A;
  auto& Bs = ring.B;
  const int m0 = bx * kBM, n0 = by * kBN;
  const int kb = bz * g.k_split;
  const int ke = min(g.K, kb + g.k_split);
  const bool quantized = g.qmask != 0 && ((g.qmask >> (m0 / g.n_pad)) & 1) != 0;
  const TileLoader<kATrans, kBM> load_a(g.A, g.lda, m0, g.M);
  const TileLoader<!kBTrans, kBN> load_b(quantized ? g.Bq : g.B, g.ldb, n0, g.N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  // rows r0..r0+3, r0+16..r0+19 and columns c0..c0+3, c0+32..c0+35: a warp's
  // float4 reads of a shared-memory row are 4 (A) and 8 (B) consecutive
  // 16-byte words, broadcast across the lanes that share them. A warp skips
  // its FMAs where its sub-tile lies past the matrix, and a half of them
  // where the second 16 rows or 32 columns do: at width 200 a 128-column
  // tile computes 224 columns, and dW's 200 x 200 computes 208 x 224.
  const int r0 = wm + (lane / 8) * 4, c0 = wn + (lane % 8) * 4;
  const bool active = m0 + wm < g.M && n0 + wn < g.N;
  const bool rows_hi = m0 + wm + 16 < g.M, cols_hi = n0 + wn + 32 < g.N;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int nk = ke > kb ? (ke - kb + kDepth - 1) / kDepth : 0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) {
      load_a.load(As[t], kb + t * kDepth, ke);
      load_b.load(Bs[t], kb + t * kDepth, ke);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    // tile t has landed; every thread is done with tile t - 1, whose slot
    // takes tile t + kStages - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < nk) {
      load_a.load(As[next % kStages], kb + next * kDepth, ke);
      load_b.load(Bs[next % kStages], kb + next * kDepth, ke);
    }
    cp_async_commit();
    const int cur = t % kStages;
    if (active && rows_hi && cols_hi) {
      fma_tile<8, 8>(As[cur], Bs[cur], r0, c0, acc);
    } else if (active && cols_hi) {
      fma_tile<4, 8>(As[cur], Bs[cur], r0, c0, acc);
    } else if (active && rows_hi) {
      fma_tile<8, 4>(As[cur], Bs[cur], r0, c0, acc);
    } else if (active) {
      fma_tile<4, 4>(As[cur], Bs[cur], r0, c0, acc);
    }
  }
  if (!active) return;
  float* __restrict__ C = g.C + bz * g.c_split;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r0 + 16 * (i / 4) + i % 4;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + c0 + 32 * (j / 4) + j % 4;
      if (n < g.N) C[static_cast<long long>(m) * g.ldc + n] = acc[i][j];
    }
  }
}

template <bool kATrans, bool kBTrans>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(Gemm g) {
  __shared__ __align__(16) Ring ring;
  gemm_tile<kATrans, kBTrans>(g, blockIdx.x, blockIdx.y, blockIdx.z, ring);
}

// Two independent products of one layer's backward in one launch, dW = H^T G
// (TN, split) and gH = G W^T (NT): the first blocks take dW's tiles (the long
// ones, so they start first), the rest gH's.
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_pair_kernel(Gemm tn, int tn_bx, int tn_by, int splits, Gemm nt, int nt_bx) {
  __shared__ __align__(16) Ring ring;
  const int tn_tiles = tn_bx * tn_by;
  const int b = blockIdx.x;
  if (b < tn_tiles * splits) {
    gemm_tile<true, false>(tn, b % tn_bx, (b / tn_bx) % tn_by, b / tn_tiles, ring);
  } else {
    const int c = b - tn_tiles * splits;
    gemm_tile<false, true>(nt, c % nt_bx, c / nt_bx, 0, ring);
  }
}

// H_0 (4 n_pad x ld_h(2) = 4): normalized (x, t), the indicator 1 on value
// rows and a zero; the constant tangents (2/(ub0-lb0), 0), (0,
// 2/(ub1-lb1)); the second-derivative stream is zero. Points past n take
// the streams of (0, 0).
__global__ void input_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                             float4* __restrict__ H) {
  const float rx = box.ub0 - box.lb0, rt = box.ub1 - box.lb1;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pad; p += gridDim.x * blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p < n) {
      xv = x[2 * p];
      tv = x[2 * p + 1];
    }
    H[p] = make_float4(2.0f * (xv - box.lb0) / rx - 1.0f, 2.0f * (tv - box.lb1) / rt - 1.0f,
                       1.0f, 0.0f);
    H[n_pad + p] = make_float4(2.0f / rx, 0.0f, 0.0f, 0.0f);
    H[2 * n_pad + p] = make_float4(0.0f, 2.0f / rt, 0.0f, 0.0f);
    H[3 * n_pad + p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The tanh factors and output streams of a hidden layer at its (rounded)
// pre-activations: K6's policy_act under kMixed, the float32 rule otherwise.
template <bool kMixed>
__device__ __forceinline__ void activate(float p, float px, float pt, float pxx, const LayerQ& lq,
                                         const Policy& q, float& s, float& d1, float& d2,
                                         float& h, float& hx, float& ht, float& hxx) {
  if constexpr (kMixed) {
    policy_act(p, px, pt, pxx, lq, q, s, d1, d2, h, hx, ht, hxx);
  } else {
    s = tanhf(p);
    d1 = 1.0f - s * s;
    d2 = -2.0f * s * d1;
    h = s;
    hx = d1 * px;
    ht = d1 * pt;
    hxx = d2 * px * px + d1 * pxx;
  }
}

__device__ __forceinline__ void store_streams(float* __restrict__ H, long long sH, long long at,
                                              float h, float hx, float ht, float hxx) {
  H[at] = h;
  H[sH + at] = hx;
  H[2 * sH + at] = ht;
  H[3 * sH + at] = hxx;
}

// The elementwise passes walk blocks of 32 x 32 threads, one block a (group
// of 32 columns, row tile of kTile points): thread (tx, ty) takes column
// 32 bx + tx of the tile's points ty, ty + 32, ... (coalesced along a row).
constexpr int kEwRows = 32;

__device__ __forceinline__ long long ew_point(int i) {
  return static_cast<long long>(blockIdx.y) * kTile + threadIdx.y + kEwRows * i;
}

// db's per-tile sums: the row lanes' double sums of a column meet in a fixed
// tree, and the tile's sum goes to sums[tile][j]. Every thread of the block
// calls it.
__device__ __forceinline__ void tile_column_sum(double v, int j, int d, double* __restrict__ sums) {
  __shared__ double part[kEwRows][32];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  for (int w = kEwRows / 2; w >= 1; w /= 2) {
    if (threadIdx.y < w) part[threadIdx.y][threadIdx.x] += part[threadIdx.y + w][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && j < d) {
    sums[static_cast<long long>(blockIdx.y) * d + j] = part[0][threadIdx.x];
  }
}

// Hidden layer l of the forward: P (4 n_pad x d) holds the product's dot
// (+ bias on value rows); under kMixed it is rounded in place as K6 rounds
// it. H receives the layer's output streams (4 n_pad x ld_h(d): column d the
// indicator, the rest of the row unused).
template <bool kMixed>
__global__ void forward_act_kernel(float* __restrict__ P, int n_pad, int d, int l, Policy q,
                                   float* __restrict__ H) {
  const LayerQ lq(q, l);
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sP = static_cast<long long>(n_pad) * d;
  const int ld = ld_h(d);
  const long long sH = static_cast<long long>(n_pad) * ld;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      store_streams(H, sH, p * ld + d, 1.0f, 0.0f, 0.0f, 0.0f);
    }
    if (j >= d) continue;
    float* pp = P + p * d + j;
    float a = pp[0], ax = pp[sP], at = pp[2 * sP], axx = pp[3 * sP];
    if constexpr (kMixed) {
      a = rq(a, lq.tv);
      ax = rq(ax, lq.td);
      at = rq(at, lq.td);
      axx = rq(axx, lq.txx);
      pp[0] = a;
      pp[sP] = ax;
      pp[2 * sP] = at;
      pp[3 * sP] = axx;
    }
    float s, d1, d2, h, hx, ht, hxx;
    activate<kMixed>(a, ax, at, axx, lq, q, s, d1, d2, h, hx, ht, hxx);
    store_streams(H, sH, p * ld + j, h, hx, ht, hxx);
  }
}

// Backward through the tanh of hidden layer l: G (4 n_pad x d) holds gH, the
// adjoints of the layer's output streams, and receives those of its
// pre-activation streams P (4 n_pad x d, as the forward stored them); sums
// (tiles x d) receives the per-tile sums of the value adjoints, in double:
// db_l. Unless null, H receives the output streams of layer l - 1,
// recomputed from its pre-activations Pb (4 n_pad x db_w; H 4 n_pad x
// ld_h(db_w)): the input of the product dW_l that the next launch pairs with
// gH of layer l.
template <bool kMixed>
__global__ void backward_act_kernel(const float* __restrict__ P, float* __restrict__ G, int n_pad,
                                    int d, int l, Policy q, double* __restrict__ sums,
                                    const float* __restrict__ Pb, int db_w,
                                    float* __restrict__ H) {
  const LayerQ lq(q, l);
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sP = static_cast<long long>(n_pad) * d;
  double db = 0.0;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (j >= d) continue;
    const long long at = p * d + j;
    const float pv = P[at], px = P[sP + at], pt = P[2 * sP + at], pxx = P[3 * sP + at];
    float s, d1, d2, h, hx, ht, hxx;
    activate<kMixed>(pv, px, pt, pxx, lq, q, s, d1, d2, h, hx, ht, hxx);
    const float gh = G[at], ghx = G[sP + at], ght = G[2 * sP + at], ghxx = G[3 * sP + at];
    const float gp = d1 * (gh - 2.0f * s * (ghx * px + ght * pt + ghxx * pxx) +
                           (6.0f * s * s - 2.0f) * ghxx * px * px);
    G[3 * sP + at] = ghxx * d1;
    G[sP + at] = ghx * d1 + 2.0f * ghxx * d2 * px;
    G[2 * sP + at] = ght * d1;
    G[at] = gp;
    db += gp;
  }
  tile_column_sum(db, j, d, sums);
  if (H == nullptr) return;
  const LayerQ lqb(q, l - 1);
  const long long sPb = static_cast<long long>(n_pad) * db_w;
  const int ld = ld_h(db_w);
  const long long sH = static_cast<long long>(n_pad) * ld;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      store_streams(H, sH, p * ld + db_w, 1.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int c = j; c < db_w; c += gridDim.x * 32) {
      const long long at = p * db_w + c;
      float s, d1, d2, h, hx, ht, hxx;
      activate<kMixed>(Pb[at], Pb[sPb + at], Pb[2 * sPb + at], Pb[3 * sPb + at], lqb, q, s, d1,
                       d2, h, hx, ht, hxx);
      store_streams(H, sH, p * ld + c, h, hx, ht, hxx);
    }
  }
}

// The head's adjoints G (4 n_pad x d): the given cotangents, zero past n;
// sums (tiles x d) receives the per-tile sums of the value cotangents.
__global__ void seed_kernel(const float* __restrict__ g0, const float* __restrict__ g1,
                            const float* __restrict__ g2, const float* __restrict__ g3, int n,
                            int n_pad, int d, float* __restrict__ G, double* __restrict__ sums) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sG = static_cast<long long>(n_pad) * d;
  double db = 0.0;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (j >= d) continue;
    const long long at = p * d + j;
    const bool in = p < n;
    const float v = in ? g0[at] : 0.0f;
    G[at] = v;
    G[sG + at] = in ? g1[at] : 0.0f;
    G[2 * sG + at] = in ? g2[at] : 0.0f;
    G[3 * sG + at] = in ? g3[at] : 0.0f;
    db += v;
  }
  tile_column_sum(db, j, d, sums);
}

// The weights K6's quantized dots multiply by: every W entry rounded to
// bf16, every bias as it is.
__global__ void round_weights_kernel(const float* __restrict__ params, Net net,
                                     float* __restrict__ wq) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < net.n_params;
       i += gridDim.x * blockDim.x) {
    bool bias = false;
    for (int l = 0; l < net.n_layers; ++l) {
      bias = bias || (i >= net.b_off[l] && i < net.b_off[l] + net.dims[l + 1]);
    }
    wq[i] = bias ? params[i] : bf16r(params[i]);
  }
}

// One thread per parameter, in double: a weight sums the split partials, a
// bias of layer l its per-tile sums (sums + l tiles max_width, tiles x
// dims[l + 1]) in tile order.
__global__ void reduce_kernel(const float* __restrict__ partials, int splits,
                              const double* __restrict__ sums, int tiles, Net net,
                              float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= net.n_params) return;
  double t = 0.0;
  for (int l = 0; l < net.n_layers; ++l) {
    const int j = i - net.b_off[l], d = net.dims[l + 1];
    if (j >= 0 && j < d) {
      const double* __restrict__ s = sums + static_cast<long long>(l) * tiles * net.max_width;
      for (int c = 0; c < tiles; ++c) t += s[static_cast<long long>(c) * d + j];
      grad[i] = static_cast<float>(t);
      return;
    }
  }
  // four chains (split z mod 4), so that four loads are in flight, joined
  // in a fixed order
  double u[4] = {0.0, 0.0, 0.0, 0.0};
  int z = 0;
  for (; z + 4 <= splits; z += 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] += partials[static_cast<long long>(z + c) * net.n_params + i];
  }
  for (; z < splits; ++z) u[0] += partials[static_cast<long long>(z) * net.n_params + i];
  grad[i] = static_cast<float>((u[0] + u[1]) + (u[2] + u[3]));
}

int ew_blocks(long long items) {
  const long long b = (items + kEwThreads - 1) / kEwThreads;
  return static_cast<int>(b < kEwMaxBlocks ? (b > 0 ? b : 1) : kEwMaxBlocks);
}

template <bool kATrans, bool kBTrans>
cudaError_t gemm(const Gemm& g, int splits, cudaStream_t s) {
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + kBN - 1) / kBN, splits);
  gemm_kernel<kATrans, kBTrans><<<grid, kGemmThreads, 0, s>>>(g);
  return cudaGetLastError();
}

#define PINNS_CHECK(expr)                          \
  do {                                             \
    const cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// The stream bits of layer l whose dots take bf16 weights (0 for float32).
int weight_mask(const Policy& q, int l, bool mixed) {
  if (!mixed || l == 0) return 0;
  return (q.qv ? 1 : 0) | (q.qd ? 6 : 0) | (q.qxx ? 8 : 0);
}

// grad (flat, params order) = d/dparams of sum over points of
// gu . u + gux . u_x + gut . u_t + guxx . u_xx, on `stream`. `dims` (host)
// holds n_layers + 1 widths; x is (n, 2), each cotangent (n, dims[n_layers]),
// all float32, contiguous, on device `device`. The points are padded to
// n_pad and dW's sum over the 4 n_pad stacked rows is cut into `splits`
// chunks of split_rows; `scratch` (16-byte aligned, scratch_floats floats)
// holds, in this order and each part starting on 16 bytes: sums, n_layers x
// tiles x max_width doubles (tiles = n_pad / kTile); h0, 4 n_pad x
// ld_h(2); pstore, the stacked pre-activations of every hidden layer (4
// n_pad x dims[l+1] each, in layer order); hbuf, 4 n_pad x
// ld_h(max_width); gbuf, 2 x 4 n_pad x max_width; partials, splits x
// n_params; and wq, n_params under kMixed. ops/kernels/taylor2.py::
// backward_plan computes the same plan; a plan that does not fit this
// layout (a padding that is not a multiple of the row tile, a split that
// does not cover the rows exactly, a smaller scratch) is refused with
// cudaErrorInvalidValue. Returns the CUDA error code of the first launch
// that failed (0 on success).
template <bool kMixed>
int launch(const float* x, int n, const float* params, const int* dims, int n_layers,
           const Policy& q, float lb0, float lb1, float ub0, float ub1, int n_pad,
           int split_rows, int splits, const float* gu, const float* gux, const float* gut,
           const float* guxx, float* scratch, long long scratch_floats, float* grad, int device,
           void* stream) {
  const long long rows = 4LL * n_pad;
  if (n < 1 || n_pad < n || n_pad % kBM != 0 || n_pad % kTile != 0 || n_layers < 1 ||
      n_layers > kMaxLayers || dims[0] != 2 || split_rows < 1 || split_rows % kBM != 0 ||
      splits < 1 || splits > 65535 || static_cast<long long>(splits) * split_rows < rows ||
      static_cast<long long>(splits - 1) * split_rows >= rows ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0) {
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
  // the products index their operands with 32-bit offsets
  if (rows * ld_h(net.max_width) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int L = n_layers, tiles = n_pad / kTile;
  // P of hidden layer l at pstore + p_off[l]; the per-tile db sums of layer
  // l at sums + l tiles max_width
  long long p_off[kMaxLayers];
  long long p_end = 0;
  for (int l = 0; l + 1 < L; ++l) {
    p_off[l] = p_end;
    p_end += rows * dims[l + 1];
  }
  const long long sums_stride = static_cast<long long>(tiles) * net.max_width;
  long long used = 0;
  const auto take = [&](long long floats) {
    float* part = scratch + used;
    used += (floats + 3) / 4 * 4;
    return part;
  };
  double* sums = reinterpret_cast<double*>(take(2 * L * sums_stride));
  float* h0 = take(rows * ld_h(2));
  float* pstore = take(p_end);
  float* hbuf = take(rows * ld_h(net.max_width));
  float* gbuf = take(2 * rows * net.max_width);
  float* partials = take(static_cast<long long>(splits) * net.n_params);
  float* wq = kMixed ? take(net.n_params) : nullptr;
  if (used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  PINNS_CHECK(cudaSetDevice(device));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Box box{lb0, lb1, ub0, ub1};
  const dim3 ew_block(32, kEwRows);
  const float* Wq = kMixed ? wq : params;
  if constexpr (kMixed) {
    round_weights_kernel<<<ew_blocks(net.n_params), kEwThreads, 0, s>>>(params, net, wq);
    PINNS_CHECK(cudaGetLastError());
  }

  // forward: H_l -> P_l -> H_l+1, for the hidden layers
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box,
                                                       reinterpret_cast<float4*>(h0));
  PINNS_CHECK(cudaGetLastError());
  for (int l = 0; l + 1 < L; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    Gemm g{l == 0 ? h0 : hbuf, params + net.w_off[l], Wq + net.w_off[l], pstore + p_off[l],
           ld_h(din), dout, dout, static_cast<int>(rows), dout, din + 1, din + 1,
           0, n_pad, weight_mask(q, l, kMixed)};
    PINNS_CHECK((gemm<false, false>(g, 1, s)));
    forward_act_kernel<kMixed><<<dim3((dout + 31) / 32, tiles), ew_block, 0, s>>>(
        pstore + p_off[l], n_pad, dout, l, q, hbuf);
    PINNS_CHECK(cudaGetLastError());
  }

  // backward, head first: G (the adjoints of layer l's pre-activation
  // streams) in one half of gbuf, the layer below's in the other; hbuf holds
  // H_l, the input streams of layer l
  float* G = gbuf;
  float* Gn = gbuf + rows * net.max_width;
  seed_kernel<<<dim3((dims[L] + 31) / 32, tiles), ew_block, 0, s>>>(
      gu, gux, gut, guxx, n, n_pad, dims[L], G, sums + (L - 1) * sums_stride);
  PINNS_CHECK(cudaGetLastError());
  for (int l = L - 1; l >= 0; --l) {
    const int din = dims[l], dout = dims[l + 1];
    // dW_l = H_l^T G over the stacked rows, split into row chunks
    const Gemm dw{l == 0 ? h0 : hbuf, G, G, partials + net.w_off[l],
                  ld_h(din), dout, dout, din, dout, static_cast<int>(rows), split_rows,
                  net.n_params, 1, 0};
    const int dw_bx = (din + kBM - 1) / kBM, dw_by = (dout + kBN - 1) / kBN;
    if (l == 0) {
      PINNS_CHECK((gemm<true, false>(dw, splits, s)));
      break;
    }
    // with gH = G W_l^T, each stream with the weights its forward dot used
    const Gemm gh{G, params + net.w_off[l], Wq + net.w_off[l], Gn,
                  dout, dout, din, static_cast<int>(rows), din, dout, dout,
                  0, n_pad, weight_mask(q, l, kMixed)};
    const int gh_bx = static_cast<int>(rows / kBM), gh_by = (din + kBN - 1) / kBN;
    gemm_pair_kernel<<<dw_bx * dw_by * splits + gh_bx * gh_by, kGemmThreads, 0, s>>>(
        dw, dw_bx, dw_by, splits, gh, gh_bx);
    PINNS_CHECK(cudaGetLastError());
    // gH -> the adjoints of layer l-1's pre-activations, and H_l-1 for the
    // next dW (layer 0's input streams are h0)
    const int below = dims[l - 1];
    backward_act_kernel<kMixed><<<dim3(((din > below ? din : below) + 31) / 32, tiles), ew_block,
                                  0, s>>>(
        pstore + p_off[l - 1], Gn, n_pad, din, l - 1, q, sums + (l - 1) * sums_stride,
        l >= 2 ? pstore + p_off[l - 2] : nullptr, below, l >= 2 ? hbuf : nullptr);
    PINNS_CHECK(cudaGetLastError());
    float* t = G;
    G = Gn;
    Gn = t;
  }
  reduce_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(partials, splits, sums, tiles, net,
                                                            grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: the backward of K1 (float32 streams).
extern "C" int pinns_taylor2_backward(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, float lb0, float lb1,
                                      float ub0, float ub1, int n_pad, int split_rows,
                                      int splits, const float* gu, const float* gux,
                                      const float* gut, const float* guxx, float* scratch,
                                      long long scratch_floats, float* grad, int device,
                                      void* stream) {
  return launch<false>(x, n, params, dims, n_layers, Policy{false, false, false, false}, lb0,
                       lb1, ub0, ub1, n_pad, split_rows, splits, gu, gux, gut, guxx, scratch,
                       scratch_floats, grad, device, stream);
}

// The backward of K6. `policy` packs K6's flags: 1 value quantized, 2 x/t
// derivatives quantized, 4 xx quantized, 8 mixed_elementwise; the scratch
// also holds the rounded weights.
extern "C" int pinns_taylor2_mixed_backward(const float* x, int n, const float* params,
                                            const int* dims, int n_layers, int policy,
                                            float lb0, float lb1, float ub0, float ub1,
                                            int n_pad, int split_rows, int splits,
                                            const float* gu, const float* gux, const float* gut,
                                            const float* guxx, float* scratch,
                                            long long scratch_floats, float* grad, int device,
                                            void* stream) {
  if (policy < 0 || policy > 15) return static_cast<int>(cudaErrorInvalidValue);
  const Policy q = decode_policy(policy);
  return launch<true>(x, n, params, dims, n_layers, q, lb0, lb1, ub0, ub1, n_pad, split_rows,
                      splits, gu, gux, gut, guxx, scratch, scratch_floats, grad, device, stream);
}

extern "C" const char* pinns_taylor2_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
