// The layer-product engine shared by the whole-call kernels: K2 and K6's
// backward (csrc/taylor2_backward.cu), the wide design of K5's forward and
// backward (csrc/mlp_forward.cu) and the wide design of K3's Adam epoch
// (csrc/fused_step.cu). Register-tiled SIMT float32
// products (TF32 is barred by the numerics rule), the elementwise passes'
// row tiles and db's per-tile double sums, and the fixed-order reduction of a
// call's partial gradients.
//
// A product's block computes a kBM x kBN tile of C = A B; each thread keeps a
// kTM x kTN register tile, so a float loaded from shared memory feeds kTN
// (kTM) FMAs. Tiles of A and B (kDepth deep) stream through kStages
// shared-memory stages filled by cp.async, zero past the edges: 16-byte copies
// where the operand runs along the tile's rows in memory, single floats
// elsewhere (any width, any leading dimension). A warp skips the FMAs of the
// rows and columns that lie past the matrix. Every launch names its tile
// (TileCfg): K2 and K6's backward take 128 x 128 tiles of 256 threads with
// 8 x 8 register tiles; K5 and K3 instantiate the engine with tile types of
// their own (namespaces k5 and k3), so that a profile tells their products
// from K2's.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kDepth = 8;
constexpr int kStages = 3;
constexpr int kTile = 128;  // the row tile of the elementwise passes and of db's sums
constexpr int kEwThreads = 256;
constexpr int kEwMaxBlocks = 132 * 16;

// A block tile of the products: kThreads threads in warps of 4 x 8 lanes,
// each lane a kTM x kTN register tile (4 or 8 each): rows r0..r0+3 and, for
// 8, r0+16..r0+19; columns c0..c0+3 and, for 8, c0+32..c0+35. A warp owns a
// (4 kTM) x (8 kTN) sub-tile, the block's warps, kWarpsN of them across the
// columns, a kBM x kBN tile. kMinBlocks is the launch bounds' blocks an SM.
template <int kThreads_, int kTM_, int kTN_, int kWarpsN_, int kMinBlocks_>
struct TileCfg {
  static constexpr int kThreads = kThreads_;
  static constexpr int kTM = kTM_;
  static constexpr int kTN = kTN_;
  static constexpr int kWarpsN = kWarpsN_;
  static constexpr int kWarpsM = kThreads_ / 32 / kWarpsN_;
  static constexpr int kBM = kWarpsM * 4 * kTM_;
  static constexpr int kBN = kWarpsN_ * 8 * kTN_;
  static constexpr int kMinBlocks = kMinBlocks_;
};

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
// 16-byte cp.async (kRows kDepth = 4 x kThreads floats a tile); elsewhere it
// copies kRows kDepth / kThreads single floats at fixed places in the tile,
// the threads of a warp walking the dimension that is contiguous in memory.
// Offsets are 32-bit (the launcher keeps every operand below 2^31 floats)
// and computed once, so a copy costs an add.
template <class Cfg, bool kContig, int kRows>
struct TileLoader {
  static constexpr int kLoads = kRows * kDepth / Cfg::kThreads;
  static constexpr int kDr = kContig ? 0 : Cfg::kThreads / kDepth;  // row step between elements
  static constexpr int kDk = kContig ? Cfg::kThreads / kRows : 0;   // depth step
  static_assert(kRows * kDepth == 4 * Cfg::kThreads, "one 16-byte copy a thread");
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
template <class Cfg>
struct Ring {
  float A[kStages][kDepth][Cfg::kBM + 4];
  float B[kStages][kDepth][Cfg::kBN + 4];
};

// One stage's FMAs into a thread's register tile: its first kRows rows and
// kCols columns (4 or 8 each; the rest lie past the matrix for the whole warp).
template <class Cfg, int kRows, int kCols>
__device__ __forceinline__ void fma_tile(float (*As)[Cfg::kBM + 4], float (*Bs)[Cfg::kBN + 4],
                                         int r0, int c0, float (&acc)[Cfg::kTM][Cfg::kTN]) {
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

// The products' epilogue: C(m, n) = the sum.
struct StoreC {
  static __device__ __forceinline__ void store(float* __restrict__ C, int ldc, int m, int n,
                                               int N, float v) {
    C[static_cast<long long>(m) * ldc + n] = v;
  }
};

// Tile (bx, by) of split bz of the product g, by the whole block; Epi stores
// each element of the tile that lies inside C.
template <class Cfg, bool kATrans, bool kBTrans, class Epi = StoreC>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int bx, int by, int bz, Ring<Cfg>& ring) {
  constexpr int kTM = Cfg::kTM, kTN = Cfg::kTN;
  auto& As = ring.A;
  auto& Bs = ring.B;
  const int m0 = bx * Cfg::kBM, n0 = by * Cfg::kBN;
  const int kb = bz * g.k_split;
  const int ke = min(g.K, kb + g.k_split);
  const bool quantized = g.qmask != 0 && ((g.qmask >> (m0 / g.n_pad)) & 1) != 0;
  const TileLoader<Cfg, kATrans, Cfg::kBM> load_a(g.A, g.lda, m0, g.M);
  const TileLoader<Cfg, !kBTrans, Cfg::kBN> load_b(quantized ? g.Bq : g.B, g.ldb, n0, g.N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / Cfg::kWarpsN) * 4 * kTM, wn = (warp % Cfg::kWarpsN) * 8 * kTN;
  // rows r0..r0+3 (, r0+16..r0+19) and columns c0..c0+3 (, c0+32..c0+35): a
  // warp's float4 reads of a shared-memory row are 4 (A) and 8 (B)
  // consecutive 16-byte words, broadcast across the lanes that share them. A
  // warp skips its FMAs where its sub-tile lies past the matrix, and, with 8
  // x 8 register tiles, a half of them where the second 16 rows or 32 columns
  // do: at width 200 a 128-column tile computes 224 columns, and dW's 200 x
  // 200 computes 208 x 224.
  const int r0 = wm + (lane / 8) * 4, c0 = wn + (lane % 8) * 4;
  const bool active = m0 + wm < g.M && n0 + wn < g.N;
  const bool rows_hi = m0 + wm + 16 < g.M, cols_hi = n0 + wn + 32 < g.N;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
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
    if constexpr (kTM == 8 && kTN == 8) {
      if (active && rows_hi && cols_hi) {
        fma_tile<Cfg, 8, 8>(As[cur], Bs[cur], r0, c0, acc);
      } else if (active && cols_hi) {
        fma_tile<Cfg, 4, 8>(As[cur], Bs[cur], r0, c0, acc);
      } else if (active && rows_hi) {
        fma_tile<Cfg, 8, 4>(As[cur], Bs[cur], r0, c0, acc);
      } else if (active) {
        fma_tile<Cfg, 4, 4>(As[cur], Bs[cur], r0, c0, acc);
      }
    } else {
      static_assert(kTM == 4 && kTN == 4, "register tiles are 8 x 8 or 4 x 4");
      if (active) fma_tile<Cfg, 4, 4>(As[cur], Bs[cur], r0, c0, acc);
    }
  }
  if (!active) return;
  float* __restrict__ C = g.C + bz * g.c_split;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + r0 + 16 * (i / 4) + i % 4;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + c0 + 32 * (j / 4) + j % 4;
      if (n < g.N) Epi::store(C, g.ldc, m, n, g.N, acc[i][j]);
    }
  }
}

template <class Cfg, bool kATrans, bool kBTrans, class Epi = StoreC>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinBlocks) gemm_kernel(Gemm g) {
  __shared__ __align__(16) Ring<Cfg> ring;
  gemm_tile<Cfg, kATrans, kBTrans, Epi>(g, blockIdx.x, blockIdx.y, blockIdx.z, ring);
}

// One product, or the splits of one, as a grid of block tiles on `s`.
template <class Cfg, bool kATrans, bool kBTrans, class Epi = StoreC>
cudaError_t gemm(const Gemm& g, int splits, cudaStream_t s) {
  const dim3 grid((g.M + Cfg::kBM - 1) / Cfg::kBM, (g.N + Cfg::kBN - 1) / Cfg::kBN, splits);
  gemm_kernel<Cfg, kATrans, kBTrans, Epi><<<grid, Cfg::kThreads, 0, s>>>(g);
  return cudaGetLastError();
}

// Two independent products of one layer's backward in one launch, dW = H^T G
// (TN, split) and gH = G W^T (NT; with kSplitNT split too, nt_bx x nt_by
// tiles a split): the first blocks take dW's tiles (the long ones, so they
// start first), the rest gH's. (Without kSplitNT gH's split index is the
// constant 0, which K2's products measurably profit from.)
template <class Cfg, bool kSplitNT>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinBlocks)
gemm_pair_kernel(Gemm tn, int tn_bx, int tn_by, int splits, Gemm nt, int nt_bx, int nt_by) {
  __shared__ __align__(16) Ring<Cfg> ring;
  const int tn_tiles = tn_bx * tn_by;
  const int b = blockIdx.x;
  if (b < tn_tiles * splits) {
    gemm_tile<Cfg, true, false>(tn, b % tn_bx, (b / tn_bx) % tn_by, b / tn_tiles, ring);
  } else {
    const int c = b - tn_tiles * splits;
    if constexpr (kSplitNT) {
      gemm_tile<Cfg, false, true>(nt, c % nt_bx, (c / nt_bx) % nt_by, c / (nt_bx * nt_by), ring);
    } else {
      gemm_tile<Cfg, false, true>(nt, c % nt_bx, c / nt_bx, 0, ring);
    }
  }
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

// Parameter i of the flat gradient, one thread each, in double: a weight sums
// the split partials, a bias of layer l its per-tile sums (sums + l tiles
// max_width, tiles x dims[l + 1]) in tile order.
__device__ __forceinline__ void reduce_param(int i, const float* __restrict__ partials, int splits,
                                             const double* __restrict__ sums, int tiles,
                                             const Net& net, float* __restrict__ grad) {
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

// The flat layout of a net's parameters (W_0, b_0, W_1, ...); false unless
// 1 <= n_layers <= kMaxLayers, the input is in_dim wide (the coordinates,
// then any shock-path features: csrc/paths.cuh) and every width is >= 1.
inline bool make_net(const int* dims, int n_layers, Net* net, int in_dim = 2) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[0] != in_dim) return false;
  net->n_layers = n_layers;
  net->max_width = 0;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    net->dims[l] = dims[l];
    if (dims[l] > net->max_width) net->max_width = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net->w_off[l] = off;
    off += dims[l] * dims[l + 1];
    net->b_off[l] = off;
    off += dims[l + 1];
  }
  net->n_params = off;
  return true;
}

// The whole-call launchers carve their `scratch` into parts that each start
// on 16 bytes.
struct Carve {
  float* base;
  long long used;
  float* take(long long floats) {
    float* part = base + used;
    used += (floats + 3) / 4 * 4;
    return part;
  }
};

#define PINNS_CHECK(expr)                          \
  do {                                             \
    const cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace
