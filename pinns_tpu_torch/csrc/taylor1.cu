// K7a: the Taylor-1 streams of the tanh MLP and their backward, for Hopper
// (sm_90a).
//
// Replaces the XLA program of pinns_tpu/ops/taylor.py::mlp_taylor_1
// (:91-129; the JAX package had no Pallas kernel for it), which carries the
// strong Euler residual at every collocation and served point: for N points
// (x, t) and an affine-input tanh MLP, (y, y_x, y_t), each (N, out_dim):
//   value stream       P = H [W; b]      H' = s = tanh P
//   derivative streams P_d = H_d W       H_d' = (1 - s^2) P_d    (d = x, t)
// the bias on the value stream only, and on the first layer the input
// rescale's chain rule: the derivative rows of H_0 are (2/(ub0-lb0), 0) and
// (0, 2/(ub1-lb1)). Its backward takes the three cotangents and gives dW, db
// of every layer; for a hidden layer with output adjoints (gh, ghx, ght):
//   gp = (1 - s^2) (gh - 2 s (ghx px + ght pt))    gpx = ghx (1 - s^2)
//   gpt = ght (1 - s^2)
// dW = sum over points and streams of H_in^T gP, db = sum of gp, and the
// input adjoints are gP W^T. ops/kernels/taylor1.py::
// taylor1_backward_reference is this algorithm in plain PyTorch.
//
// Two designs, chosen by ops/kernels/taylor1.py::taylor1_plan from the
// widths and the paths. Every output's float32 sum is the same in both: k
// ascending, fmaf from zero, the bias added last (as the indicator column of
// the wide design's stacked input), so their forwards agree bit for bit.
//
// The wide design (any width above 32, and every shock-path net): whole-call
// layer products on the engine of layer_gemm.cuh. A layer's three streams
// live stream-major in one (3 n_pad x ld) buffer: rows [s n_pad, (s + 1)
// n_pad) hold stream s (value, x, t) of the points 0..n_pad-1, n_pad a
// multiple of 128. Padded points take the streams of the point (0, 0) and a
// zero cotangent. Every stacked input H carries one more column, 1 on value
// rows and 0 on derivative rows, so that the flat [W_l; b_l] (b_l follows W_l
// in pack_params order) is one (din + 1) x dout matrix and P = H [W; b] adds
// the bias to value rows only. A layer's products are three-stream tiles: a
// block computes the value, x and t sums of the same points and units, each
// thread a 4-point x kTN-unit register tile of each stream (48 or 96
// accumulators) from one shared W tile, so the tanh rule and its adjoint run
// in the product's epilogue.
//   forward   an input pass writes H_0; per hidden layer one product whose
//             epilogue applies the rule and writes the next H, 16 bytes a
//             store; the head's three streams in one launch into y, y_x, y_t.
//             L + 1 launches for L layers (7 at the Euler trunk 2x200x5x3);
//   backward  the forward again, keeping H of every layer (no
//             pre-activations: the rule's adjoint is written in the outputs,
//             d1 gh - 2 s (ghx hx + ght ht)); the head's adjoints seeded with
//             the cotangents; per layer, head first, one launch of dW_l =
//             H_l^T G (TN over the stacked rows, split over row chunks into
//             per-split partials) and gH = G W_l^T (NT, three-stream tiles)
//             whose epilogue applies the rule's adjoint at H_l and sums the
//             value adjoints per row tile in double (db); then one thread per
//             parameter sums, in double and in a fixed order, a weight's
//             partials or a bias's per-tile sums. 2 L + 2 launches (14 at the
//             Euler trunk).
// Fourier and shock-path features (csrc/fourier.cuh, csrc/paths.cuh;
// pinns_tpu/models/mlp.py:223-340): with F Fourier features and K paths,
// H_0's rows become [x^, t^, sin z_1..F, cos z_1..F, phi_1 .. phi_K, 1, 0
// ...] and the tangent rows carry each point's x and t streams of them,
// computed in the input pass from B (by value) and from path_c and path_a
// (after the trunk in the flat params), so that [W_0; b_0] has 2 + 2F + K + 1
// rows. B is fixed, so the Fourier features need no backward of their own;
// with paths the backward takes layer 0's gH too,
// in the launch of its dW, and one pass with a thread a point applies the
// paths' chain rule to gH's path columns of the three streams, summing per
// 128-point block in double; the reduction sums the blocks in order. The
// backward takes one more launch (15 at the Euler trunk).
// The block tile is the plan's: dW's on 32 x 32 tiles of 64 threads below
// about one 128 x 128 block an SM, K2's 128 x 128 of 256 threads above; the
// three-stream tiles take the same threads, since a layer's dW and gH share
// a launch: 32 points x 32 units with 4 x 4 register tiles below, above 32
// points x 128 units with 4 x 4 for gH and 64 points x 128 units with 4 x 8
// for the forward's layer products (the faster of the two at two blocks an
// SM, scripts/k7a_k8s_bits.py).
//
// The narrow design (every width <= 32 and no paths: the 8x20 nets of the
// Burgers ensembles' d/dx and twosin_weak's edge points): K1's per-tile
// kernel with three streams and no xx. A block takes up to 128 points, its
// streams in shared memory ([stream][unit][point], ping-ponged between two
// buffers), a thread a (unit, 4 points); one launch forward. The backward is
// two launches, as K5's narrow backward: a per-tile kernel that recomputes
// the forward (keeping each hidden layer's output streams in its block's
// slice of the scratch), walks the layers back in shared memory and adds its
// tiles' dW and db into its block's partials, then a fixed-order reduction.
//
// No atomics, so two calls agree bit for bit. Every launch goes on the
// caller's stream from one host call. The caller allocates the scratch, one
// buffer that the launcher lays out and checks against its size
// (taylor1_plan). Products stay float32 FMA (TF32 is barred by the numerics
// rule). Every kernel is in namespace k7, so a profile tells them from K2's
// and K5's.
//
// What bounds it on the H100: the operations of the products. At the Euler
// trunk a point's three streams take 161,000 multiply-adds each through the
// layers: about 0.97 MFLOP a point forward and three times that backward
// (forward again, dW and gH), so at N 1,000 0.97 GFLOP forward, 0.014 ms at
// 67 TFLOP/s, where the chain of dependent launches (latency) is what the
// call waits on; at N 65,536 63 GFLOP forward, 0.94 ms. The three-stream
// tiles keep the rule out of separate elementwise passes, so P and G make no
// extra round trips through device memory and a layer is one launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "layer_gemm.cuh"
#include "paths.cuh"

namespace {
namespace k7 {

constexpr int kStreams = 3;
struct SmallTile : TileCfg<64, 4, 4, 1, 8> {};
struct LargeTile : TileCfg<256, 8, 8, 2, 2> {};

// A three-stream block tile: kThreads threads in warps of 4 x 8 lanes, each
// lane 4 points (rows r0..r0+3) by kTN units (c0..c0+3 and, for 8,
// c0+32..c0+35) of each of the three streams; a warp 16 points by 8 kTN
// units, kWarpsN warps across the units.
template <int kThreads_, int kTN_, int kWarpsN_, int kMinBlocks_>
struct Tile3 {
  static constexpr int kThreads = kThreads_;
  static constexpr int kTN = kTN_;
  static constexpr int kWarpsN = kWarpsN_;
  static constexpr int kWarpsM = kThreads_ / 32 / kWarpsN_;
  static constexpr int kBM = kWarpsM * 16;
  static constexpr int kBN = kWarpsN_ * 8 * kTN_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kRowGroups = kWarpsM * 4;  // lanes that share a unit
};
// The three-stream tiles of each dW tile: Layer for the forward's layer
// products (no spills at two blocks an SM: 96 accumulators in 128
// registers), Grad for gH's, which shares a launch with dW's tiles and
// whose tile of points is db's row tile.
struct SmallTile3 : Tile3<64, 4, 1, 8> {};    // 32 points x 32 units
struct LayerTile3 : Tile3<256, 8, 2, 2> {};   // 64 points x 128 units
struct GradTile3 : Tile3<256, 4, 4, 2> {};    // 32 points x 128 units
template <class Cfg>
struct ThreeOf;
template <>
struct ThreeOf<SmallTile> {
  using Layer = SmallTile3;
  using Grad = SmallTile3;
};
template <>
struct ThreeOf<LargeTile> {
  using Layer = LayerTile3;
  using Grad = GradTile3;
};

// C (M x N) = A (M x K) B (K x N) for each of three streams: stream s's A at
// A + s sA (row-major, leading dimension lda); B(k, n) = B[k ldb + n], or
// with kBTrans B[n ldb + k]. M is a multiple of the block tile's points.
struct Prod3 {
  const float* A;
  long long sA;
  int lda;
  const float* B;
  int ldb;
  int M, N, K;
};

template <class T3>
struct Ring3 {
  float A[kStages][kStreams][kDepth][T3::kBM + 4];
  float B[kStages][kDepth][T3::kBN + 4];
};

// The copies of the three streams' A tiles: a thread takes kLoads single
// floats of each, the threads of a warp walking the depth (contiguous in
// memory), zero past k1.
template <class T3>
struct ALoader3 {
  static constexpr int kLoads = T3::kBM * kDepth / T3::kThreads;
  static constexpr int kDr = T3::kThreads / kDepth;
  static_assert(kLoads * T3::kThreads == T3::kBM * kDepth, "whole copies a thread");
  const float* A;
  long long sA;
  int r, k, base, step;

  __device__ ALoader3(const Prod3& g, int m0) : A(g.A), sA(g.sA) {
    r = threadIdx.x / kDepth;
    k = threadIdx.x % kDepth;
    base = (m0 + r) * g.lda + k;
    step = kDr * g.lda;
  }

  __device__ __forceinline__ void load(float (*S)[kDepth][T3::kBM + 4], int k0, int k1) const {
    const bool ok = k0 + k < k1;
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const float* X = A + s * sA;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        cp_async4(&S[s][k][r + i * kDr], ok ? X + base + k0 + i * step : X, ok);
      }
    }
  }
};

// Where a thread's register tile lies: points m..m+3, units n..n+3 and, for
// kTN 8, n+32..n+35 (of the whole matrix); `active` unless the warp's units
// all lie past N.
struct Frag {
  int m, n, row_group, col;  // col: n's place in the block tile
  bool active;
};

template <class T3, int kCols>
__device__ __forceinline__ void fma3(float (*As)[kDepth][T3::kBM + 4],
                                     float (*Bs)[T3::kBN + 4], int r0, int c0,
                                     float (&acc)[kStreams][4][T3::kTN]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    float a[kStreams][4], b[8];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(&As[s][k][r0]);
      a[s][0] = v.x;
      a[s][1] = v.y;
      a[s][2] = v.z;
      a[s][3] = v.w;
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
    for (int s = 0; s < kStreams; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[s][i][j] = fmaf(a[s][i], b[j], acc[s][i][j]);
      }
    }
  }
}

// Tile (bx, by) of the three products g by the whole block, into the
// threads' accumulators: each output the engine's chain (k ascending from 0,
// fmaf from zero, kDepth-deep stages zero past K), so that it equals
// gemm_tile's sum of the same row bit for bit.
template <class T3, bool kBTrans>
__device__ __forceinline__ Frag product3(const Prod3& g, int bx, int by, Ring3<T3>& ring,
                                         float (&acc)[kStreams][4][T3::kTN]) {
  const int m0 = bx * T3::kBM, n0 = by * T3::kBN;
  const ALoader3<T3> load_a(g, m0);
  const TileLoader<T3, !kBTrans, T3::kBN> load_b(g.B, g.ldb, n0, g.N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / T3::kWarpsN) * 16, wn = (warp % T3::kWarpsN) * 8 * T3::kTN;
  const int r0 = wm + (lane / 8) * 4, c0 = wn + (lane % 8) * 4;
  Frag f{m0 + r0, n0 + c0, (warp / T3::kWarpsN) * 4 + lane / 8, c0, n0 + wn < g.N};
  const bool cols_hi = T3::kTN == 8 && n0 + wn + 32 < g.N;
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < T3::kTN; ++j) acc[s][i][j] = 0.0f;
    }
  }
  const int nk = (g.K + kDepth - 1) / kDepth;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) {
      load_a.load(ring.A[t], t * kDepth, g.K);
      load_b.load(ring.B[t], t * kDepth, g.K);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < nk) {
      load_a.load(ring.A[next % kStages], next * kDepth, g.K);
      load_b.load(ring.B[next % kStages], next * kDepth, g.K);
    }
    cp_async_commit();
    const int cur = t % kStages;
    if (f.active) {
      if constexpr (T3::kTN == 8) {
        if (cols_hi) {
          fma3<T3, 8>(ring.A[cur], ring.B[cur], r0, c0, acc);
        } else {
          fma3<T3, 4>(ring.A[cur], ring.B[cur], r0, c0, acc);
        }
      } else {
        fma3<T3, 4>(ring.A[cur], ring.B[cur], r0, c0, acc);
      }
    }
  }
  return f;
}

// Unit j of a thread's register tile: its column in the matrix.
__device__ __forceinline__ int unit(const Frag& f, int j) {
  return f.n + 32 * (j / 4) + j % 4;
}

// H_0 (3 n_pad x ld_h(2 + 2F + K)): normalized (x, t), the Fourier and the
// path features, the indicator 1 on value rows and zeros; the tangent rows
// (2/(ub0-lb0), 0, ..) and (0, 2/(ub1-lb1), ..) with the features' x and t
// streams (csrc/fourier.cuh::write_input_rows). Points past n take the
// streams of (0, 0).
__global__ void input_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                             Fourier fo, Paths paths, float* __restrict__ H) {
  const int ld = ld_h(embed_width(fo, paths));
  const long long sH = static_cast<long long>(n_pad) * ld;
  const float sx = 2.0f / (box.ub0 - box.lb0), st = 2.0f / (box.ub1 - box.lb1);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pad; p += gridDim.x * blockDim.x) {
    float xn, tn;
    normalized_point(x, p, n, box, &xn, &tn);
    float* row = H + static_cast<long long>(p) * ld;
    write_input_rows(fo, paths, xn, tn, sx, st, ld, 1, row, row + sH, row + 2 * sH, nullptr);
  }
}

// The path gradient's per-block partials (path_grad_block) from gH_0 (3 n_pad
// x ld_g), the adjoints of H_0's columns, the path columns from 2 + 2F on.
__global__ void path_grad_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                                 int n_fourier, Paths paths, const float* __restrict__ gh,
                                 int ld_g, double* __restrict__ psums) {
  const long long plane = static_cast<long long>(n_pad) * ld_g;
  const int c = 2 + 2 * n_fourier;
  path_grad_block(x, n, box, paths, gh + c, gh + plane + c, gh + 2 * plane + c, nullptr, ld_g,
                  psums);
}

// The output streams of a hidden unit at its pre-activations (a, ax, at).
// Both designs take this one expression.
__device__ __forceinline__ void act3(float a, float ax, float at_, float* s, float* hx,
                                     float* ht) {
  const float t = tanhf(a);
  const float d1 = 1.0f - t * t;
  *s = t;
  *hx = d1 * ax;
  *ht = d1 * at_;
}

// The rule's adjoint at a hidden unit, given the adjoints (gh, ghx, ght) of
// its output streams, from those streams (s, hx, ht) = (tanh pv, (1 - s^2)
// px, (1 - s^2) pt), which both backwards keep in place of the
// pre-activations: d1 gh - 2 s (ghx hx + ght ht) is d1 (gh - 2 s (ghx px +
// ght pt)) with d1 taken into the sum.
__device__ __forceinline__ void act3_adjoint_at_outputs(float s, float hx, float ht, float gh,
                                                        float ghx, float ght, float* gp,
                                                        float* gpx, float* gpt) {
  const float d1 = 1.0f - s * s;
  *gp = d1 * gh - 2.0f * s * (ghx * hx + ght * ht);
  *gpx = ghx * d1;
  *gpt = ght * d1;
}

// The bias's indicator of row p of a stacked input of width d: 1 on the
// value row, 0 on the derivative rows.
__device__ __forceinline__ void indicator(float* __restrict__ H, long long sH, long long p,
                                          int ld, int d) {
  H[p * ld + d] = 1.0f;
  H[sH + p * ld + d] = 0.0f;
  H[2 * sH + p * ld + d] = 0.0f;
}

// Four consecutive floats at p (16-byte aligned) into v, or from v.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A hidden layer of the wide design: the three products H_l [W_l; b_l] (g),
// and in their epilogue the rule into H (3 M x ldo, the next stacked input,
// with its indicator; ldo a multiple of 4). A thread's 4 consecutive units
// of a point go out as one 16-byte store a stream where all lie inside N.
template <class T3>
__global__ void __launch_bounds__(T3::kThreads, T3::kMinBlocks)
layer_kernel(Prod3 g, float* __restrict__ H, int ldo) {
  __shared__ __align__(16) Ring3<T3> ring;
  float acc[kStreams][4][T3::kTN];
  const Frag f = product3<T3, false>(g, blockIdx.x, blockIdx.y, ring, acc);
  const long long sH = static_cast<long long>(g.M) * ldo;
  if (blockIdx.y == 0 && threadIdx.x < T3::kBM) {
    indicator(H, sH, static_cast<long long>(blockIdx.x) * T3::kBM + threadIdx.x, ldo, g.N);
  }
  if (!f.active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = f.m + i;
#pragma unroll
    for (int q = 0; q < T3::kTN / 4; ++q) {
      const int n = f.n + 32 * q;
      if (n >= g.N) continue;
      float o[kStreams][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        act3(acc[0][i][4 * q + j], acc[1][i][4 * q + j], acc[2][i][4 * q + j], &o[0][j],
             &o[1][j], &o[2][j]);
      }
      float* at = H + m * ldo + n;
      if (n + 3 < g.N) {
#pragma unroll
        for (int st = 0; st < kStreams; ++st) store4(at + st * sH, o[st]);
      } else {
        for (int j = 0; n + j < g.N && j < 4; ++j) {
#pragma unroll
          for (int st = 0; st < kStreams; ++st) at[st * sH + j] = o[st][j];
        }
      }
    }
  }
}

// The head: the three products into y, y_x, y_t (n x N), points past n
// dropped.
template <class T3>
__global__ void __launch_bounds__(T3::kThreads, T3::kMinBlocks)
head_kernel(Prod3 g, int n, float* __restrict__ y, float* __restrict__ y_x,
            float* __restrict__ y_t) {
  __shared__ __align__(16) Ring3<T3> ring;
  float acc[kStreams][4][T3::kTN];
  const Frag f = product3<T3, false>(g, blockIdx.x, blockIdx.y, ring, acc);
  if (!f.active) return;
  float* outs[kStreams] = {y, y_x, y_t};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = f.m + i;
    if (m >= n) continue;
#pragma unroll
    for (int j = 0; j < T3::kTN; ++j) {
      const int c = unit(f, j);
      if (c >= g.N) continue;
#pragma unroll
      for (int s = 0; s < kStreams; ++s) outs[s][m * g.N + c] = acc[s][i][j];
    }
  }
}

template <class Cfg, class T3>
union PairSmem {
  Ring<Cfg> dw;
  Ring3<T3> gh;
  double part[T3::kRowGroups][T3::kBN];
};

// One layer of the wide backward in one launch: the first blocks take dW =
// H^T G's tiles (the engine's TN product, split; the long ones, so they
// start first), the rest gH = G W^T's three-stream tiles. With kRule, gH's
// epilogue applies the rule's adjoint at the layer below's output streams Hb
// (3 M x ldb, H_l itself) into Gn (3 M x N) and writes the tile's sums of
// the value adjoints, in double, to sums[bx][n]: each thread's 4 points in
// order, then the tile's row groups in order. Without it (layer 0 of a path
// net), Gn receives gH. 16-byte loads and stores where N % 4 == 0 and a
// thread's 4 units lie inside N.
template <class Cfg, class T3, bool kRule>
__global__ void __launch_bounds__(Cfg::kThreads, T3::kMinBlocks)
pair_kernel(Gemm dw, int dw_bx, int dw_by, int splits, Prod3 gh, int gh_bx,
            const float* __restrict__ Hb, int ldb, float* __restrict__ Gn,
            double* __restrict__ sums) {
  static_assert(T3::kThreads == Cfg::kThreads, "dW's and gH's tiles share a launch");
  __shared__ __align__(16) PairSmem<Cfg, T3> sm;
  const int dw_tiles = dw_bx * dw_by;
  const int b = blockIdx.x;
  if (b < dw_tiles * splits) {
    gemm_tile<Cfg, true, false>(dw, b % dw_bx, (b / dw_bx) % dw_by, b / dw_tiles, sm.dw);
    return;
  }
  const int c = b - dw_tiles * splits;
  const int bx = c % gh_bx, by = c / gh_bx;
  float acc[kStreams][4][T3::kTN];
  const Frag f = product3<T3, true>(gh, bx, by, sm.gh, acc);
  const long long sG = static_cast<long long>(gh.M) * gh.N;
  const long long sB = static_cast<long long>(gh.M) * ldb;
  const bool vec = gh.N % 4 == 0;
  double db[T3::kTN];
#pragma unroll
  for (int j = 0; j < T3::kTN; ++j) db[j] = 0.0;
  if (f.active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = f.m + i;
#pragma unroll
      for (int q = 0; q < T3::kTN / 4; ++q) {
        const int n = f.n + 32 * q;
        if (n >= gh.N) continue;
        const bool whole = vec && n + 3 < gh.N;
        float o[kStreams][4];
        if constexpr (kRule) {
          float h[kStreams][4];
          const float* hb = Hb + m * ldb + n;
#pragma unroll
          for (int st = 0; st < kStreams; ++st) {
            if (whole) {
              load4(hb + st * sB, h[st]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) h[st][j] = n + j < gh.N ? hb[st * sB + j] : 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            act3_adjoint_at_outputs(h[0][j], h[1][j], h[2][j], acc[0][i][4 * q + j],
                                    acc[1][i][4 * q + j], acc[2][i][4 * q + j], &o[0][j],
                                    &o[1][j], &o[2][j]);
            if (n + j < gh.N) db[4 * q + j] += o[0][j];
          }
        } else {
#pragma unroll
          for (int st = 0; st < kStreams; ++st) {
#pragma unroll
            for (int j = 0; j < 4; ++j) o[st][j] = acc[st][i][4 * q + j];
          }
        }
        float* at = Gn + m * gh.N + n;
        if (whole) {
#pragma unroll
          for (int st = 0; st < kStreams; ++st) store4(at + st * sG, o[st]);
        } else {
          for (int j = 0; n + j < gh.N && j < 4; ++j) {
#pragma unroll
            for (int st = 0; st < kStreams; ++st) at[st * sG + j] = o[st][j];
          }
        }
      }
    }
  }
  if constexpr (kRule) {
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int j = 0; j < T3::kTN; ++j) sm.part[f.row_group][f.col + 32 * (j / 4) + j % 4] = db[j];
    __syncthreads();
    const int n = by * T3::kBN + static_cast<int>(threadIdx.x);
    if (threadIdx.x < T3::kBN && n < gh.N) {
      double t = 0.0;
      for (int r = 0; r < T3::kRowGroups; ++r) t += sm.part[r][threadIdx.x];
      sums[static_cast<long long>(bx) * gh.N + n] = t;
    }
  }
}

// The head's adjoints G (3 n_pad x d): the given cotangents, zero past n;
// sums (n_pad / tile x d) receives the per-tile sums of the value cotangents
// (tile a multiple of kEwRows points).
__global__ void seed_kernel(const float* __restrict__ g0, const float* __restrict__ g1,
                            const float* __restrict__ g2, int n, int n_pad, int d, int tile,
                            float* __restrict__ G, double* __restrict__ sums) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sG = static_cast<long long>(n_pad) * d;
  double db = 0.0;
  for (int i = 0; i < tile / kEwRows; ++i) {
    const long long p = static_cast<long long>(blockIdx.y) * tile + threadIdx.y + kEwRows * i;
    if (j >= d) continue;
    const long long at = p * d + j;
    const bool in = p < n;
    const float v = in ? g0[at] : 0.0f;
    G[at] = v;
    G[sG + at] = in ? g1[at] : 0.0f;
    G[2 * sG + at] = in ? g2[at] : 0.0f;
    db += v;
  }
  tile_column_sum(db, j, d, sums);
}

// Bias i of layer l, if it is one: its per-tile sums (sums + l tiles
// max_width, tiles x d) in four chains (tile mod 4), so that four loads are in
// flight, joined in a fixed order.
__device__ __forceinline__ bool bias_sum(int i, const double* __restrict__ sums, int tiles,
                                         const Net& net, float* __restrict__ grad) {
  for (int l = 0; l < net.n_layers; ++l) {
    const int j = i - net.b_off[l], d = net.dims[l + 1];
    if (j < 0 || j >= d) continue;
    const double* __restrict__ s = sums + static_cast<long long>(l) * tiles * net.max_width;
    double u[4] = {0.0, 0.0, 0.0, 0.0};
    int c = 0;
    for (; c + 4 <= tiles; c += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] += s[static_cast<long long>(c + q) * d + j];
    }
    for (; c < tiles; ++c) u[0] += s[static_cast<long long>(c) * d + j];
    grad[i] = static_cast<float>((u[0] + u[1]) + (u[2] + u[3]));
    return true;
  }
  return false;
}

// One thread a parameter: a bias's per-tile sums (bias_sum over `tiles` row
// tiles), a weight's split partials (reduce_param), then the paths' from
// their per-block partials (psums, blocks x n_path).
__global__ void reduce_kernel(const float* __restrict__ partials, int splits,
                              const double* __restrict__ sums, int tiles, Net net,
                              const double* __restrict__ psums, int blocks, int n_path,
                              float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < net.n_params) {
    if (!bias_sum(i, sums, tiles, net, grad)) {
      reduce_param(i, partials, splits, sums, tiles, net, grad);
    }
  } else if (i < net.n_params + n_path) {
    grad[i] = path_grad_sum(psums, blocks, n_path, i - net.n_params);
  }
}

// The hidden layers of the wide design from H_0 = h0: layer l reads H_l (h0,
// or Hof(l)) and writes H_l+1 = Hof(l + 1). Returns the CUDA error of the
// first launch that failed.
template <class T3, class HOf>
int hidden_layers(const Net& net, const float* params, const float* h0, int n_pad, HOf Hof,
                  cudaStream_t s) {
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* in = l == 0 ? h0 : Hof(l);
    const Prod3 g{in, static_cast<long long>(n_pad) * ld_h(din), ld_h(din), params + net.w_off[l],
                  dout, n_pad, dout, din + 1};
    const dim3 grid(n_pad / T3::kBM, (dout + T3::kBN - 1) / T3::kBN);
    layer_kernel<T3><<<grid, T3::kThreads, 0, s>>>(g, Hof(l + 1), ld_h(dout));
    PINNS_CHECK(cudaGetLastError());
  }
  return static_cast<int>(cudaSuccess);
}

// The checks both wide launchers make of a plan (n >= 1): a padding that is
// a whole number of row tiles, a tile the file instantiates, an aligned
// scratch, Fourier features and paths within bounds and an input width 2 +
// 2 n_fourier + n_paths, operands that 32-bit offsets reach.
bool plan_ok(const int* dims, int n_layers, int n_fourier, int n_paths, int path_degree, int n,
             int n_pad, int tile, const float* scratch, Net* net) {
  if (n < 1 || n_pad < n || n_pad % kTile != 0 || n_pad / kTile > 65535 ||
      (tile != SmallTile::kBM && tile != LargeTile::kBM) ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0 || !paths_ok(n_paths, path_degree) ||
      !fourier_ok(n_fourier) || !make_net(dims, n_layers, net, 2 + 2 * n_fourier + n_paths)) {
    return false;
  }
  return static_cast<long long>(kStreams) * n_pad * ld_h(net->max_width) <= 0x7fffffffLL;
}

template <class Cfg>
int forward(const float* x, int n, const float* params, const Net& net, const Fourier& fo,
            const Paths& paths, const Box& box, int n_pad, float* scratch, long long scratch_floats, float* y,
            float* y_x, float* y_t, cudaStream_t s) {
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  Carve c{scratch, 0};
  float* h0 = c.take(rows * ld_h(net.dims[0]));
  float* hbuf[2] = {c.take(rows * ld_h(net.max_width)), c.take(rows * ld_h(net.max_width))};
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, fo, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  // H_l (l >= 1) ping-pongs between the two buffers
  const auto Hof = [&](int l) { return hbuf[(l - 1) % 2]; };
  const int err = hidden_layers<typename ThreeOf<Cfg>::Layer>(net, params, h0, n_pad, Hof, s);
  if (err != 0) return err;
  const int l = net.n_layers - 1, din = net.dims[l], dout = net.dims[l + 1];
  const Prod3 head{l == 0 ? h0 : Hof(l), static_cast<long long>(n_pad) * ld_h(din), ld_h(din),
                   params + net.w_off[l], dout, n_pad, dout, din + 1};
  const dim3 grid(n_pad / SmallTile3::kBM, (dout + SmallTile3::kBN - 1) / SmallTile3::kBN);
  head_kernel<SmallTile3><<<grid, SmallTile3::kThreads, 0, s>>>(head, n, y, y_x, y_t);
  return static_cast<int>(cudaGetLastError());
}

template <class Cfg>
int backward(const float* x, int n, const float* params, const Net& net, const Fourier& fo,
             const Paths& paths, const Box& box, int n_pad, int split_rows, int splits, const float* gy,
             const float* gyx, const float* gyt, float* scratch, long long scratch_floats,
             float* grad, cudaStream_t s) {
  using T3 = typename ThreeOf<Cfg>::Grad;
  const int L = net.n_layers, tiles = n_pad / T3::kBM, blocks = n_pad / kTile;
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  // H_l (l >= 1, the outputs of hidden layer l - 1) at hstore + h_off[l];
  // the per-tile db sums of layer l at sums + l tiles max_width
  long long h_off[kMaxLayers + 1];
  long long h_end = 0;
  for (int l = 0; l + 1 < L; ++l) {
    h_off[l + 1] = h_end;
    h_end += rows * ld_h(net.dims[l + 1]);
  }
  const long long sums_stride = static_cast<long long>(tiles) * net.max_width;
  Carve c{scratch, 0};
  double* sums = reinterpret_cast<double*>(c.take(2 * L * sums_stride));
  float* h0 = c.take(rows * ld_h(net.dims[0]));
  float* hstore = c.take(h_end);
  float* gbuf = c.take(2 * rows * net.max_width);
  float* partials = c.take(static_cast<long long>(splits) * net.n_params);
  double* psums = reinterpret_cast<double*>(c.take(2LL * blocks * paths.n_params()));
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, fo, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  const auto Hof = [&](int l) { return hstore + h_off[l]; };
  const int err = hidden_layers<typename ThreeOf<Cfg>::Layer>(net, params, h0, n_pad, Hof, s);
  if (err != 0) return err;

  // head first: G holds the adjoints of layer l's pre-activation streams,
  // Gn receives those of the layer below
  float* G = gbuf;
  float* Gn = gbuf + rows * net.max_width;
  seed_kernel<<<dim3((net.dims[L] + 31) / 32, tiles), dim3(32, kEwRows), 0, s>>>(
      gy, gyx, gyt, n, n_pad, net.dims[L], T3::kBM, G, sums + (L - 1) * sums_stride);
  PINNS_CHECK(cudaGetLastError());
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    // dW_l = H_l^T G over the stacked rows, split into row chunks
    const Gemm dw{l == 0 ? h0 : Hof(l), G, G, partials + net.w_off[l], ld_h(din), dout, dout,
                  din, dout, static_cast<int>(rows), split_rows, net.n_params, 1, 0};
    if (l == 0 && paths.k == 0) {
      PINNS_CHECK((gemm<Cfg, true, false>(dw, splits, s)));
      break;
    }
    // with gH = G W_l^T (at layer 0 the adjoints of the path features)
    const int dw_bx = (din + Cfg::kBM - 1) / Cfg::kBM, dw_by = (dout + Cfg::kBN - 1) / Cfg::kBN;
    const Prod3 gh{G, static_cast<long long>(n_pad) * dout, dout, params + net.w_off[l], dout,
                   n_pad, din, dout};
    const int gh_bx = n_pad / T3::kBM, gh_by = (din + T3::kBN - 1) / T3::kBN;
    const int grid = dw_bx * dw_by * splits + gh_bx * gh_by;
    if (l == 0) {
      pair_kernel<Cfg, T3, false><<<grid, Cfg::kThreads, 0, s>>>(dw, dw_bx, dw_by, splits, gh,
                                                                 gh_bx, nullptr, 0, Gn, nullptr);
      PINNS_CHECK(cudaGetLastError());
      path_grad_kernel<<<blocks, kTile, kTile * sizeof(double), s>>>(x, n, n_pad, box, fo.f,
                                                                     paths, Gn, din, psums);
      PINNS_CHECK(cudaGetLastError());
      break;
    }
    pair_kernel<Cfg, T3, true><<<grid, Cfg::kThreads, 0, s>>>(
        dw, dw_bx, dw_by, splits, gh, gh_bx, Hof(l), ld_h(din), Gn,
        sums + (l - 1) * sums_stride);
    PINNS_CHECK(cudaGetLastError());
    float* t = G;
    G = Gn;
    Gn = t;
  }
  const int n_path = paths.n_params();
  reduce_kernel<<<(net.n_params + n_path + 255) / 256, 256, 0, s>>>(
      partials, splits, sums, tiles, net, psums, blocks, n_path, grad);
  return static_cast<int>(cudaGetLastError());
}

// -- the narrow design --------------------------------------------------------

constexpr int kNarrowWidth = 32;
constexpr int kR = 4;                // points a thread item (one float4 a stream)
constexpr int kNarrowThreads = 640;  // the forward's __launch_bounds__ (K1's)
constexpr int kNarrowBwdThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[kR]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// The three input streams of the tile's points into buf ([stream][unit]
// [point], plane floats a stream, ts a unit): the rows write_input_rows
// makes for the wide design's H_0, without paths.
__device__ __forceinline__ void narrow_inputs(float* buf, int plane, int ts,
                                              const float* __restrict__ x, int n, long long p0,
                                              int tile, const Box& box) {
  const Paths none{0, 0, nullptr, nullptr};
  Fourier plain;
  plain.f = 0;
  const float sx = 2.0f / (box.ub0 - box.lb0), st = 2.0f / (box.ub1 - box.lb1);
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    float xn, tn, hv[4], hx[4], ht[4];
    normalized_point(x, p0 + p, n, box, &xn, &tn);
    write_input_rows(plain, none, xn, tn, sx, st, 4, 1, hv, hx, ht, nullptr);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      buf[k * ts + p] = hv[k];
      buf[plane + k * ts + p] = hx[k];
      buf[2 * plane + k * ts + p] = ht[k];
    }
  }
}

// The three sums of unit j of a layer at 4 points (the wide design's chain:
// k ascending, then the bias through the indicator: 1 on the value stream,
// 0 on the others).
__device__ __forceinline__ void dense3(const float* in, int plane, int ts,
                                       const float* __restrict__ W, float bj, int din, int dout,
                                       int j, int pc, float (&a)[kStreams][kR]) {
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
#pragma unroll
    for (int r = 0; r < kR; ++r) a[s][r] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float w = __ldg(W + k * dout + j);
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const float4 h = ld4(in + s * plane + k * ts + pc);
      a[s][0] = fmaf(h.x, w, a[s][0]);
      a[s][1] = fmaf(h.y, w, a[s][1]);
      a[s][2] = fmaf(h.z, w, a[s][2]);
      a[s][3] = fmaf(h.w, w, a[s][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[0][r] = fmaf(1.0f, bj, a[0][r]);
    a[1][r] = fmaf(0.0f, bj, a[1][r]);
    a[2][r] = fmaf(0.0f, bj, a[2][r]);
  }
}

// The hidden layers of a tile whose input streams are in `in`, ping-ponging
// with `out`; with `store`, hidden layer l's output streams go to store +
// l 3 max_width tile ([stream][unit][point]). Returns the buffer that holds
// the last hidden layer's outputs.
__device__ float* narrow_hidden(const Net& net, const float* __restrict__ params, float* in,
                                float* out, int plane, int tile, int ts,
                                float* __restrict__ store) {
  const int groups = tile / kR;
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* __restrict__ W = params + net.w_off[l];
    const float* __restrict__ b = params + net.b_off[l];
    float* keep = store == nullptr
                      ? nullptr
                      : store + static_cast<long long>(l) * kStreams * net.max_width * tile;
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      float a[kStreams][kR];
      dense3(in, plane, ts, W, b[j], din, dout, j, pc, a);
      float o[kStreams][kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) act3(a[0][r], a[1][r], a[2][r], &o[0][r], &o[1][r], &o[2][r]);
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        st4(out + s * plane + j * ts + pc, o[s]);
        if (keep != nullptr) st4(keep + (s * net.max_width + j) * tile + pc, o[s]);
      }
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
  return in;
}

__global__ void __launch_bounds__(kNarrowThreads)
narrow_forward_kernel(const float* __restrict__ x, int n, const float* __restrict__ params,
                      Net net, Box box, int tile, float* __restrict__ y,
                      float* __restrict__ y_x, float* __restrict__ y_t) {
  extern __shared__ float4 smem4[];
  const int ts = tile + 4;  // a unit's row, padded against bank conflicts
  const int plane = net.max_width * ts;
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + kStreams * plane;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  narrow_inputs(bufA, plane, ts, x, n, p0, tile, box);
  __syncthreads();
  const float* X = narrow_hidden(net, params, bufA, bufB, plane, tile, ts, nullptr);
  const int l = net.n_layers - 1, din = net.dims[l], dout = net.dims[l + 1];
  const float* __restrict__ W = params + net.w_off[l];
  const float* __restrict__ b = params + net.b_off[l];
  float* outs[kStreams] = {y, y_x, y_t};
  for (int item = threadIdx.x; item < (tile / kR) * dout; item += blockDim.x) {
    const int g = item / dout;
    const int j = item - g * dout;
    const int pc = g * kR;
    float a[kStreams][kR];
    dense3(X, plane, ts, W, b[j], din, dout, j, pc, a);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long p = p0 + pc + r;
      if (p >= n) continue;
#pragma unroll
      for (int s = 0; s < kStreams; ++s) outs[s][p * dout + j] = a[s][r];
    }
  }
}

// The narrow backward's per-tile kernel: block b takes tiles b, b + grid, ...
// and adds each tile's dW and db into its partials (partials + b n_params,
// the first tile's stored, the later ones added in float32). Shared memory:
// X (the current layer's input streams), G (the adjoints of its
// pre-activations), Y (the layer below's), each three planes.
__global__ void __launch_bounds__(kNarrowBwdThreads)
narrow_backward_kernel(const float* __restrict__ x, int n, const float* __restrict__ params,
                       Net net, Box box, int tile, const float* __restrict__ g0,
                       const float* __restrict__ g1, const float* __restrict__ g2,
                       float* __restrict__ partials, float* __restrict__ hstore) {
  extern __shared__ float4 smem4[];
  const int T = tile, ts = T + 4;
  const int plane = net.max_width * ts;
  float* X = reinterpret_cast<float*>(smem4);
  float* G0 = X + kStreams * plane;
  float* Y0 = G0 + kStreams * plane;
  const int L = net.n_layers;
  const int d_head = net.dims[L];
  float* store = hstore + static_cast<long long>(blockIdx.x) * (L - 1) * kStreams *
                              net.max_width * T;
  float* part = partials + static_cast<long long>(blockIdx.x) * net.n_params;
  const int n_tiles = (n + T - 1) / T;
  const int groups = T / kR;
  const float* gin[kStreams] = {g0, g1, g2};

  for (int tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const bool first = tix == static_cast<int>(blockIdx.x);
    const long long p0 = static_cast<long long>(tix) * T;
    narrow_inputs(X, plane, ts, x, n, p0, T, box);
    __syncthreads();
    narrow_hidden(net, params, X, Y0, plane, T, ts, store);
    float* G = G0;
    float* Y = Y0;
    for (int e = threadIdx.x; e < d_head * T; e += blockDim.x) {
      const int j = e / T, t = e - j * T;
      const bool in = p0 + t < n;
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        G[s * plane + j * ts + t] = in ? gin[s][(p0 + t) * d_head + j] : 0.0f;
      }
    }
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      // X = H_l: the inputs, or hidden layer l-1's kept output streams
      if (l == 0) {
        narrow_inputs(X, plane, ts, x, n, p0, T, box);
      } else {
        const float* kept = store + static_cast<long long>(l - 1) * kStreams * net.max_width * T;
        for (int e = threadIdx.x; e < kStreams * din * T; e += blockDim.x) {
          const int s = e / (din * T), k = (e / T) % din, t = e % T;
          X[s * plane + k * ts + t] = kept[(s * net.max_width + k) * T + t];
        }
      }
      __syncthreads();
      const float* __restrict__ W = params + net.w_off[l];
      const int n_w = din * dout + dout;
      const int n_items = n_w + (l > 0 ? din * groups : 0);
      for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        if (item < din * dout) {
          // dW[k][j] = sum over streams and points of X_s[k][t] G_s[j][t]
          const int k = item / dout, j = item - k * dout;
          float acc = 0.0f;
          for (int s = 0; s < kStreams; ++s) {
            for (int t = 0; t < T; t += kR) {
              const float4 xv = ld4(X + s * plane + k * ts + t);
              const float4 gv = ld4(G + s * plane + j * ts + t);
              acc = fmaf(xv.x, gv.x, acc);
              acc = fmaf(xv.y, gv.y, acc);
              acc = fmaf(xv.z, gv.z, acc);
              acc = fmaf(xv.w, gv.w, acc);
            }
          }
          const int o = net.w_off[l] + item;
          part[o] = first ? acc : part[o] + acc;
        } else if (item < n_w) {
          // db[j] = sum over points of G_0[j][t]
          const int j = item - din * dout;
          float acc = 0.0f;
          for (int t = 0; t < T; ++t) acc += G[j * ts + t];
          const int o = net.b_off[l] + j;
          part[o] = first ? acc : part[o] + acc;
        } else {
          // the rule's adjoint at layer l-1's unit k, 4 points
          const int e = item - n_w;
          const int g = e / din, k = e - g * din;
          const int pc = g * kR;
          float gh[kStreams][kR];
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
#pragma unroll
            for (int r = 0; r < kR; ++r) gh[s][r] = 0.0f;
          }
          for (int j = 0; j < dout; ++j) {
            const float w = __ldg(W + k * dout + j);
#pragma unroll
            for (int s = 0; s < kStreams; ++s) {
              const float4 gv = ld4(G + s * plane + j * ts + pc);
#pragma unroll
              for (int r = 0; r < kR; ++r) gh[s][r] = fmaf(get(gv, r), w, gh[s][r]);
            }
          }
          // at the unit's output streams, X: H_l is layer l-1's output
          const float4 hv = ld4(X + k * ts + pc), hx = ld4(X + plane + k * ts + pc);
          const float4 ht = ld4(X + 2 * plane + k * ts + pc);
          float o[kStreams][kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            act3_adjoint_at_outputs(get(hv, r), get(hx, r), get(ht, r), gh[0][r], gh[1][r],
                                    gh[2][r], &o[0][r], &o[1][r], &o[2][r]);
          }
#pragma unroll
          for (int s = 0; s < kStreams; ++s) st4(Y + s * plane + k * ts + pc, o[s]);
        }
      }
      __syncthreads();
      float* t = G;
      G = Y;
      Y = t;
    }
  }
}

// One thread a parameter: the blocks' partials summed in double in block
// order.
__global__ void narrow_reduce_kernel(const float* __restrict__ partials, int rows, int n_params,
                                     float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  double s = 0.0;
  for (int b = 0; b < rows; ++b) s += partials[static_cast<long long>(b) * n_params + i];
  grad[i] = static_cast<float>(s);
}

// The narrow net's layout: every width <= kNarrowWidth, no paths;
// max_width the widest layer.
bool narrow_net(const int* dims, int n_layers, Net* net) {
  if (!make_net(dims, n_layers, net)) return false;
  return net->max_width <= kNarrowWidth;
}

size_t narrow_smem_bytes(int buffers, int max_width, int tile) {
  return sizeof(float) * static_cast<size_t>(buffers) * kStreams *
         static_cast<size_t>(max_width) * static_cast<size_t>(tile + 4);
}

// The device the caller named, made current only when it is not.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace k7

using namespace k7;

}  // namespace

// (y, y_x, y_t) of the MLP at x on `stream`, the wide design. `dims` (host)
// holds n_layers + 1 widths, dims[0] = 2 + 2 n_fourier + n_paths; `fourier`
// (host) the 2 n_fourier frequencies, 2 pi B[:, 0] then 2 pi B[:, 1]
// (csrc/fourier.cuh), null without Fourier features; `params` (device) W_0,
// b_0, W_1, b_1, ... back to back, then with n_paths > 0 path_c (n_paths x
// (path_degree + 1)) and path_a (n_paths). x is (n, 2), each output (n,
// dims[n_layers]), float32, contiguous, on device `device`. The points are
// padded to n_pad and the products take the block tile `tile` (32 or 128);
// `scratch` (16-byte aligned, scratch_floats floats) holds, each part on 16
// bytes, h0 (3 n_pad x ld_h(dims[0])) and two stacked inputs (3 n_pad x
// ld_h(max_width) each). ops/kernels/taylor1.py::taylor1_plan computes the
// same plan; one that does not fit this layout is refused with
// cudaErrorInvalidValue. Returns the CUDA error code of the first launch
// that failed (0 on success).
extern "C" int pinns_taylor1_forward(const float* x, int n, const float* params, const int* dims,
                                     int n_layers, int n_fourier, const float* fourier,
                                     int n_paths, int path_degree, float lb0,
                                     float lb1, float ub0, float ub1, int n_pad, int tile,
                                     float* scratch, long long scratch_floats, float* y,
                                     float* y_x, float* y_t, int device, void* stream) {
  Net net;
  if (!plan_ok(dims, n_layers, n_fourier, n_paths, path_degree, n, n_pad, tile, scratch,
               &net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(use_device(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  const Fourier fo = make_fourier(n_fourier, fourier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? forward<SmallTile>(x, n, params, net, fo, paths, box, n_pad, scratch,
                                  scratch_floats, y, y_x, y_t, s)
             : forward<LargeTile>(x, n, params, net, fo, paths, box, n_pad, scratch,
                                  scratch_floats, y, y_x, y_t, s);
}

// grad (flat, params order) = d/dparams of sum over points of
// gy . y + gyx . y_x + gyt . y_t, on `stream`, the wide design; the
// arguments as the forward's, with the cotangents (n, dims[n_layers]) each;
// grad has the trunk's parameters, then the paths'. dW's sum over the 3 n_pad
// stacked rows is cut into `splits` chunks of split_rows (a multiple of 32);
// `scratch` holds, in this order and each part on 16 bytes: sums, n_layers x
// tiles x max_width doubles (tiles = n_pad / the three-stream tile's points:
// 32 with tile 32, 64 with tile 128); h0, 3 n_pad x ld_h(dims[0]); the
// pre-activations of every hidden layer (3 n_pad x dims[l + 1] each, in layer
// order); the stacked outputs of every hidden layer (3 n_pad x
// ld_h(dims[l + 1]) each, in layer order); gbuf, 2 x 3 n_pad x max_width;
// partials, splits x the trunk's n_params; psums, n_pad / 128 x n_paths
// (path_degree + 2) doubles.
extern "C" int pinns_taylor1_backward(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, int n_fourier,
                                      const float* fourier, int n_paths,
                                      int path_degree, float lb0, float lb1, float ub0,
                                      float ub1, int n_pad, int tile, int split_rows,
                                      int splits, const float* gy, const float* gyx,
                                      const float* gyt, float* scratch,
                                      long long scratch_floats, float* grad, int device,
                                      void* stream) {
  Net net;
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  if (!plan_ok(dims, n_layers, n_fourier, n_paths, path_degree, n, n_pad, tile, scratch,
               &net) ||
      split_rows < 1 ||
      split_rows % 32 != 0 || splits < 1 || static_cast<long long>(splits) * split_rows < rows ||
      static_cast<long long>(splits - 1) * split_rows >= rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(use_device(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  const Fourier fo = make_fourier(n_fourier, fourier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? backward<SmallTile>(x, n, params, net, fo, paths, box, n_pad, split_rows, splits,
                                   gy, gyx, gyt, scratch, scratch_floats, grad, s)
             : backward<LargeTile>(x, n, params, net, fo, paths, box, n_pad, split_rows, splits,
                                   gy, gyx, gyt, scratch, scratch_floats, grad, s);
}

// (y, y_x, y_t) on `stream`, the narrow design: one launch of `threads`
// threads a block of `tile` points (a multiple of 4, at most 128), for a net
// without paths whose widths are all at most 32. The other arguments as the
// wide forward's.
extern "C" int pinns_taylor1_narrow_forward(const float* x, int n, const float* params,
                                            const int* dims, int n_layers, float lb0, float lb1,
                                            float ub0, float ub1, int tile, int threads,
                                            float* y, float* y_x, float* y_t, int device,
                                            void* stream) {
  Net net;
  if (n < 1 || !narrow_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 ||
      tile > 128 || threads < 32 || threads > kNarrowThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(use_device(device));
  const size_t smem = narrow_smem_bytes(2, net.max_width, tile);
  PINNS_CHECK(cudaFuncSetAttribute(narrow_forward_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem)));
  const Box box{lb0, lb1, ub0, ub1};
  narrow_forward_kernel<<<(n + tile - 1) / tile, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(x, n, params, net, box, tile, y,
                                                               y_x, y_t);
  return static_cast<int>(cudaGetLastError());
}

// The gradient on `stream`, the narrow design: `grid` blocks of the per-tile
// kernel over tiles of `tile` points (a multiple of 4, at most 64), then the
// reduction. `scratch` (scratch_floats floats) holds, each part on 16 bytes,
// the blocks' partials (grid x n_params) and their kept output streams (grid
// x (n_layers - 1) x 3 x max_width x tile). The other arguments as the wide
// backward's.
extern "C" int pinns_taylor1_narrow_backward(const float* x, int n, const float* params,
                                             const int* dims, int n_layers, float lb0,
                                             float lb1, float ub0, float ub1, int tile, int grid,
                                             const float* gy, const float* gyx, const float* gyt,
                                             float* scratch, long long scratch_floats,
                                             float* grad, int device, void* stream) {
  Net net;
  if (n < 1 || !narrow_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 || tile > 64 ||
      grid < 1 || grid > (n + tile - 1) / tile || (reinterpret_cast<size_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Carve c{scratch, 0};
  float* partials = c.take(static_cast<long long>(grid) * net.n_params);
  float* hstore = c.take(static_cast<long long>(grid) * (n_layers - 1) * kStreams *
                         net.max_width * tile);
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  PINNS_CHECK(use_device(device));
  const size_t smem = narrow_smem_bytes(3, net.max_width, tile);
  PINNS_CHECK(cudaFuncSetAttribute(narrow_backward_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem)));
  const Box box{lb0, lb1, ub0, ub1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  narrow_backward_kernel<<<grid, kNarrowBwdThreads, smem, s>>>(x, n, params, net, box, tile, gy,
                                                               gyx, gyt, partials, hstore);
  PINNS_CHECK(cudaGetLastError());
  narrow_reduce_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(partials, grid, net.n_params,
                                                                  grad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_taylor1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
