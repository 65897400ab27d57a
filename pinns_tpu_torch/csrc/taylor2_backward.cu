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
// The products run on the engine of layer_gemm.cuh (gemm_tile): a block
// computes a 128 x 128 tile with 256 threads; each thread keeps an 8 x 8
// register tile, so a float loaded from shared memory feeds 8 FMAs. Tiles of
// A and B (8 deep) stream through three shared-memory stages filled by
// cp.async, zero past the edges: 16-byte copies where the operand runs along
// the tile's rows in memory (both operands of dW = H^T G, whose H rows are
// padded to 16 bytes, and the weights of the forward's products), single
// floats elsewhere (any width, any leading dimension). A warp owns a 32 x 64
// sub-tile and skips the FMAs of the rows and columns that lie past the
// matrix by halves: at width 200 a 128-column tile computes 224 columns, not
// 256, and dW's 200 x 200 computes 208 x 224. Products stay float32 FMA:
// TF32 is barred by the numerics rule, and the cotangents are float32.
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
// Fourier and shock-path features (float32 only; csrc/fourier.cuh,
// csrc/paths.cuh): with F Fourier features and K paths the input pass writes
// the four streams of H_0 = [x^, t^, sin z_1..F, cos z_1..F, phi_1..K, 1, 0
// ...] (the xx row carries the features' second derivatives), so layer 0's
// dW takes 2 + 2F + K + 1 rows. B is fixed: the Fourier features need
// nothing more. With paths, layer 0's gH = G W_0^T is taken in the launch of
// its dW, and one pass with a thread a point applies the paths' chain rule
// (the xx stream's phi_xx = -2 phi (1 - phi^2) zx^2 with its adjoint) to the
// path columns of the four streams, the terms in double, summed per 128-
// point block through a fixed tree and over the blocks in block order by
// the reduction (one launch more).
//
// What bounds it on the H100: the operations. At 8x200 and one 8,192-point
// microbatch of burgers_scale the three products of a layer are each
// 32,768 x 200 x 200 (55 GFLOP a call, 823 us at 67 TFLOP/s fp32); the
// elementwise passes move about 1.3 GB (0.4 ms at 3.35 TB/s). Measured on an
// H100 at 700 W (PERF.md, Findings): the products at 37-41% of the fp32
// peak. At 8x20 and a few thousand points, the 36 launches' host cost.

#include <cuda_runtime.h>
#include <stddef.h>

#include "layer_gemm.cuh"
#include "paths.cuh"
#include "taylor2_policy.cuh"

namespace {

// The products: 128 x 128 tiles of 256 threads, each an 8 x 8 register
// tile; a warp's lanes are 4 x 8 threads (a 32 x 64 sub-tile), the block's
// warps 4 x 2 (layer_gemm.cuh).
using Tile = TileCfg<256, 8, 8, 2, 2>;
constexpr int kBM = Tile::kBM;
constexpr int kBN = Tile::kBN;
constexpr int kGemmThreads = Tile::kThreads;

// H_0 (4 n_pad x ld_h(2 + 2F + K)): normalized (x, t), the Fourier and path
// features, the indicator 1 on value rows and zeros; the tangent rows
// (2/(ub0-lb0), 0, ..) and (0, 2/(ub1-lb1), ..) and the xx row (0, 0, ..)
// with the features' streams (csrc/fourier.cuh::write_input_rows; without
// features the second-derivative stream is zero). Points past n take the
// streams of (0, 0).
__global__ void input_kernel(const float* __restrict__ x, int n, int n_pad, Box box, Fourier fo,
                             Paths paths, float* __restrict__ H) {
  const int ld = ld_h(embed_width(fo, paths));
  const long long sH = static_cast<long long>(n_pad) * ld;
  const float sx = 2.0f / (box.ub0 - box.lb0), st = 2.0f / (box.ub1 - box.lb1);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pad; p += gridDim.x * blockDim.x) {
    float xn, tn;
    normalized_point(x, p, n, box, &xn, &tn);
    float* row = H + static_cast<long long>(p) * ld;
    write_input_rows(fo, paths, xn, tn, sx, st, ld, 1, row, row + sH, row + 2 * sH,
                     row + 3 * sH);
  }
}

// The path gradient's per-block partials (path_grad_block) from gH_0 (4 n_pad
// x ld_g), the adjoints of H_0's columns of the four streams, the path
// columns from 2 + 2F on.
__global__ void path_grad_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                                 int n_fourier, Paths paths, const float* __restrict__ gh,
                                 int ld_g, double* __restrict__ psums) {
  const long long plane = static_cast<long long>(n_pad) * ld_g;
  const int c = 2 + 2 * n_fourier;
  path_grad_block(x, n, box, paths, gh + c, gh + plane + c, gh + 2 * plane + c,
                  gh + 3 * plane + c, ld_g, psums);
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
// dims[l + 1]) in tile order; a path parameter its blocks' partials in block
// order (path_grad_sum).
__global__ void reduce_kernel(const float* __restrict__ partials, int splits,
                              const double* __restrict__ sums, int tiles, Net net,
                              const double* __restrict__ psums, int blocks, int n_path,
                              float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < net.n_params) {
    reduce_param(i, partials, splits, sums, tiles, net, grad);
  } else if (i < net.n_params + n_path) {
    grad[i] = path_grad_sum(psums, blocks, n_path, i - net.n_params);
  }
}

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
// n_params; wq, n_params under kMixed; and psums, n_pad / 128 x n_paths
// (path_degree + 2) doubles. With Fourier features or paths (float32 only)
// dims[0] = 2 + 2 fo.f + n_paths, h0 is 4 n_pad x ld_h(dims[0]) and grad
// holds the trunk's parameters, then the paths' (path_c, path_a after the
// trunk in `params`). ops/kernels/taylor2.py::
// backward_plan computes the same plan; a plan that does not fit this
// layout (a padding that is not a multiple of the row tile, a split that
// does not cover the rows exactly, a smaller scratch) is refused with
// cudaErrorInvalidValue. Returns the CUDA error code of the first launch
// that failed (0 on success).
template <bool kMixed>
int launch(const float* x, int n, const float* params, const int* dims, int n_layers,
           const Fourier& fo, int n_paths, int path_degree,
           const Policy& q, float lb0, float lb1, float ub0, float ub1, int n_pad,
           int split_rows, int splits, const float* gu, const float* gux, const float* gut,
           const float* guxx, float* scratch, long long scratch_floats, float* grad, int device,
           void* stream) {
  const long long rows = 4LL * n_pad;
  if (n < 1 || n_pad < n || n_pad % kBM != 0 || n_pad % kTile != 0 || n_layers < 1 ||
      n_layers > kMaxLayers || !fourier_ok(fo.f) || !paths_ok(n_paths, path_degree) ||
      (kMixed && (fo.f > 0 || n_paths > 0)) || split_rows < 1 || split_rows % kBM != 0 ||
      splits < 1 || splits > 65535 || static_cast<long long>(splits) * split_rows < rows ||
      static_cast<long long>(splits - 1) * split_rows >= rows ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net;
  if (!make_net(dims, n_layers, &net, 2 + 2 * fo.f + n_paths)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  float* h0 = take(rows * ld_h(dims[0]));
  float* pstore = take(p_end);
  float* hbuf = take(rows * ld_h(net.max_width));
  float* gbuf = take(2 * rows * net.max_width);
  float* partials = take(static_cast<long long>(splits) * net.n_params);
  float* wq = kMixed ? take(net.n_params) : nullptr;
  const int blocks = n_pad / kTile;
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  const int n_path = paths.n_params();
  double* psums = reinterpret_cast<double*>(take(2LL * blocks * n_path));
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
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, fo, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  for (int l = 0; l + 1 < L; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    Gemm g{l == 0 ? h0 : hbuf, params + net.w_off[l], Wq + net.w_off[l], pstore + p_off[l],
           ld_h(din), dout, dout, static_cast<int>(rows), dout, din + 1, din + 1,
           0, n_pad, weight_mask(q, l, kMixed)};
    PINNS_CHECK((gemm<Tile, false, false>(g, 1, s)));
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
    if (l == 0 && n_paths == 0) {
      PINNS_CHECK((gemm<Tile, true, false>(dw, splits, s)));
      break;
    }
    // with gH = G W_l^T, each stream with the weights its forward dot used
    const Gemm gh{G, params + net.w_off[l], Wq + net.w_off[l], Gn,
                  dout, dout, din, static_cast<int>(rows), din, dout, dout,
                  0, n_pad, weight_mask(q, l, kMixed)};
    const int gh_bx = static_cast<int>(rows / kBM), gh_by = (din + kBN - 1) / kBN;
    gemm_pair_kernel<Tile, false>
        <<<dw_bx * dw_by * splits + gh_bx * gh_by, kGemmThreads, 0, s>>>(
            dw, dw_bx, dw_by, splits, gh, gh_bx, gh_by);
    PINNS_CHECK(cudaGetLastError());
    if (l == 0) {  // gH_0's path columns: the paths' chain rule
      path_grad_kernel<<<blocks, kTile, kTile * sizeof(double), s>>>(x, n, n_pad, box, fo.f,
                                                                     paths, Gn, din, psums);
      PINNS_CHECK(cudaGetLastError());
      break;
    }
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
  reduce_kernel<<<(net.n_params + n_path + 255) / 256, 256, 0, s>>>(
      partials, splits, sums, tiles, net, psums, blocks, n_path, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: the backward of K1 (float32 streams).
// `fourier` (host memory) holds the n_fourier frequencies 2 pi B[:, 0], then
// the n_fourier 2 pi B[:, 1] (null when n_fourier is 0).
extern "C" int pinns_taylor2_backward(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, int n_fourier,
                                      const float* fourier, int n_paths, int path_degree,
                                      float lb0, float lb1,
                                      float ub0, float ub1, int n_pad, int split_rows,
                                      int splits, const float* gu, const float* gux,
                                      const float* gut, const float* guxx, float* scratch,
                                      long long scratch_floats, float* grad, int device,
                                      void* stream) {
  if (!fourier_ok(n_fourier)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, n, params, dims, n_layers, make_fourier(n_fourier, fourier), n_paths,
                       path_degree, Policy{false, false, false, false}, lb0, lb1, ub0, ub1,
                       n_pad, split_rows, splits, gu, gux, gut, guxx, scratch,
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
  return launch<true>(x, n, params, dims, n_layers, make_fourier(0, nullptr), 0, 0, q, lb0, lb1,
                      ub0, ub1, n_pad, split_rows,
                      splits, gu, gux, gut, guxx, scratch, scratch_floats, grad, device, stream);
}

// ---------------------------------------------------------------------------
// K2's float64 mode (pinns_taylor2_backward_f64: `polish`'s residual on the
// card), every width <= kF64Width, no features. A simple design of its own,
// not the product engine above: block b walks the tiles of kF64Tile points
// b, b + grid, ... Per tile, the four input streams and every layer's
// working streams stay in shared memory (three buffers of 4 x max_width x
// kF64Tile doubles, [stream][unit][point]); the forward runs the hidden
// layers (a thread a (unit, point): the four dots in __fma_rn, the bias
// added after, the tanh rule) and keeps each layer's pre-activation
// streams in the block's global scratch (L2); the backward seeds the head
// with the cotangents and goes back layer by layer: dW[k][j] = sum over
// streams, then points, of H_s[k][t] G_s[j][t], db[j] = sum over points of
// G_value[j][t], added into the block's row of partials (tile after tile in
// walk order), and the adjoints of the layer below from gH_s = G_s W^T and
// the stored pre-activations (the formulas at the head of this file; s, s',
// s'' recomputed from p by the forward's own code, so they are its bits).
// A second launch sums the partial rows in block order, a thread a
// parameter. No atomics: two calls agree bit for bit. Its plain version is
// ops/kernels/taylor2.py::taylor2_backward_reference in float64.
namespace k2d {

constexpr int kF64Width = 32;
constexpr int kF64Tile = 32;
constexpr int kF64Threads = 256;
constexpr int kF64MaxLayers = 32;

struct NetF64 {
  int n_layers;
  int max_width;
  int dims[kF64MaxLayers + 1];
  long long w_off[kF64MaxLayers];
  long long b_off[kF64MaxLayers];
  long long n_params;
};

// The tanh rule of one unit at one point: the output streams from the
// pre-activation streams.
__device__ __forceinline__ void act(double p, double px, double pt, double pxx, double* s,
                                    double* sx, double* st, double* sxx) {
  const double t = tanh(p);
  const double d1 = 1.0 - t * t;
  const double d2 = -2.0 * t * d1;
  *s = t;
  *sx = d1 * px;
  *st = d1 * pt;
  *sxx = d2 * px * px + d1 * pxx;
}

// The input streams of the tile's points into X ([stream][row][point]);
// zero past n.
__device__ __forceinline__ void load_inputs(double* X, int plane, const double* __restrict__ x,
                                            int n, long long p0, double lb0, double lb1,
                                            double ub0, double ub1) {
  const double rx = ub0 - lb0, rt = ub1 - lb1;
  for (int p = threadIdx.x; p < kF64Tile; p += blockDim.x) {
    double xv = 0.0, tv = 0.0;
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    X[0 * kF64Tile + p] = 2.0 * (xv - lb0) / rx - 1.0;
    X[1 * kF64Tile + p] = 2.0 * (tv - lb1) / rt - 1.0;
    X[plane + 0 * kF64Tile + p] = 2.0 / rx;
    X[plane + 1 * kF64Tile + p] = 0.0;
    X[2 * plane + 0 * kF64Tile + p] = 0.0;
    X[2 * plane + 1 * kF64Tile + p] = 2.0 / rt;
    X[3 * plane + 0 * kF64Tile + p] = 0.0;
    X[3 * plane + 1 * kF64Tile + p] = 0.0;
  }
}

__global__ void __launch_bounds__(kF64Threads)
backward_kernel(const double* __restrict__ x, int n, const double* __restrict__ params,
                NetF64 net, double lb0, double lb1, double ub0, double ub1,
                const double* __restrict__ gu, const double* __restrict__ gux,
                const double* __restrict__ gut, const double* __restrict__ guxx,
                double* __restrict__ partials, double* __restrict__ pstore) {
  extern __shared__ double2 smem2[];
  const int plane = net.max_width * kF64Tile;  // one stream of one buffer
  double* X = reinterpret_cast<double*>(smem2);
  double* G = X + 4 * plane;
  double* Y = G + 4 * plane;
  const int L = net.n_layers;
  const int d_head = net.dims[L];
  const long long layer_size = 4LL * plane;  // one layer's pre-activation streams
  double* P = pstore + static_cast<long long>(blockIdx.x) * (L - 1) * layer_size;
  double* part = partials + static_cast<long long>(blockIdx.x) * net.n_params;
  const double* gs[4] = {gu, gux, gut, guxx};
  const int n_tiles = (n + kF64Tile - 1) / kF64Tile;

  for (int tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const bool first = tix == static_cast<int>(blockIdx.x);
    const long long p0 = static_cast<long long>(tix) * kF64Tile;
    load_inputs(X, plane, x, n, p0, lb0, lb1, ub0, ub1);
    __syncthreads();
    // the forward over the hidden layers: X holds layer l's input streams
    for (int l = 0; l < L - 1; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      const double* __restrict__ W = params + net.w_off[l];
      const double* __restrict__ b = params + net.b_off[l];
      double* Pl = P + l * layer_size;
      for (int item = threadIdx.x; item < dout * kF64Tile; item += blockDim.x) {
        const int j = item / kF64Tile, t = item - j * kF64Tile;
        double a[4] = {0.0, 0.0, 0.0, 0.0};
        for (int k = 0; k < din; ++k) {
          const double w = __ldg(W + static_cast<long long>(k) * dout + j);
#pragma unroll
          for (int s = 0; s < 4; ++s) a[s] = __fma_rn(X[s * plane + k * kF64Tile + t], w, a[s]);
        }
        a[0] = a[0] + b[j];
#pragma unroll
        for (int s = 0; s < 4; ++s) Pl[s * plane + j * kF64Tile + t] = a[s];
        const int o = j * kF64Tile + t;
        act(a[0], a[1], a[2], a[3], Y + o, Y + plane + o, Y + 2 * plane + o, Y + 3 * plane + o);
      }
      __syncthreads();
      double* tmp = X;
      X = Y;
      Y = tmp;
    }
    // the head's adjoints: the cotangents (zero past n)
    for (int e = threadIdx.x; e < d_head * kF64Tile; e += blockDim.x) {
      const int j = e / kF64Tile, t = e - j * kF64Tile;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        G[s * plane + j * kF64Tile + t] = p0 + t < n ? gs[s][(p0 + t) * d_head + j] : 0.0;
      }
    }
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      if (l < L - 1) {  // X: layer l's input streams, again
        if (l == 0) {
          load_inputs(X, plane, x, n, p0, lb0, lb1, ub0, ub1);
        } else {
          const double* Pb = P + (l - 1) * layer_size;
          for (int e = threadIdx.x; e < din * kF64Tile; e += blockDim.x) {
            act(Pb[e], Pb[plane + e], Pb[2 * plane + e], Pb[3 * plane + e], X + e, X + plane + e,
                X + 2 * plane + e, X + 3 * plane + e);
          }
        }
      }
      __syncthreads();
      const double* __restrict__ W = params + net.w_off[l];
      const int n_w = din * dout + dout;
      const int n_items = n_w + (l > 0 ? din * kF64Tile : 0);
      const double* Pb = l > 0 ? P + (l - 1) * layer_size : nullptr;
      for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        if (item < din * dout) {  // dW[k][j]: the streams in turn, each over the points
          const int k = item / dout, j = item - k * dout;
          double acc = 0.0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const double* xs = X + s * plane + k * kF64Tile;
            const double* g = G + s * plane + j * kF64Tile;
            for (int t = 0; t < kF64Tile; ++t) acc = __fma_rn(xs[t], g[t], acc);
          }
          const long long o = net.w_off[l] + item;
          part[o] = first ? acc : part[o] + acc;
        } else if (item < n_w) {  // db[j]: the value stream over the points
          const int j = item - din * dout;
          double acc = 0.0;
          for (int t = 0; t < kF64Tile; ++t) acc += G[j * kF64Tile + t];
          const long long o = net.b_off[l] + j;
          part[o] = first ? acc : part[o] + acc;
        } else {  // the adjoints of layer l-1's pre-activation streams at (k, t)
          const int e = item - n_w;
          const int k = e / kF64Tile, t = e - k * kF64Tile;
          double gh[4] = {0.0, 0.0, 0.0, 0.0};
          for (int j = 0; j < dout; ++j) {
            const double w = __ldg(W + static_cast<long long>(k) * dout + j);
#pragma unroll
            for (int s = 0; s < 4; ++s) gh[s] = __fma_rn(G[s * plane + j * kF64Tile + t], w, gh[s]);
          }
          const int o = k * kF64Tile + t;
          const double px = Pb[plane + o], pt = Pb[2 * plane + o], pxx = Pb[3 * plane + o];
          const double sv = X[o];  // tanh of the pre-activation: the layer's input value
          const double d1 = 1.0 - sv * sv;
          const double d2 = -2.0 * sv * d1;
          Y[3 * plane + o] = gh[3] * d1;
          Y[plane + o] = gh[1] * d1 + 2.0 * gh[3] * d2 * px;
          Y[2 * plane + o] = gh[2] * d1;
          Y[o] = d1 * (gh[0] - 2.0 * sv * (gh[1] * px + gh[2] * pt + gh[3] * pxx) +
                       (6.0 * sv * sv - 2.0) * gh[3] * px * px);
        }
      }
      __syncthreads();
      double* tmp = G;
      G = Y;
      Y = tmp;
    }
  }
}

// One thread per parameter: the partial rows summed in block order.
__global__ void reduce_kernel(const double* __restrict__ partials, int rows, long long n_params,
                              double* __restrict__ grad) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  double s = 0.0;
  for (int b = 0; b < rows; ++b) s += partials[static_cast<long long>(b) * n_params + i];
  grad[i] = s;
}

size_t smem_bytes(int max_width) {
  return sizeof(double) * 3u * 4u * static_cast<size_t>(max_width) * kF64Tile;
}

}  // namespace k2d

extern "C" const char* pinns_taylor2_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2's float64 mode on `stream`: grad (flat, pack_params order, float64) of
// sum over points and streams of the cotangents (gu, gux, gut, guxx: (n,
// dims[n_layers]) float64) dotted with (u, u_x, u_t, u_xx) of the float64
// net. `grid` blocks (1 <= grid <= the tiles of kF64Tile points); scratch:
// `partials` (grid x n_params) and `pstore` (grid x (n_layers - 1) x 4 x
// max_width x kF64Tile) doubles (ops/kernels/taylor2.py::f64_backward_plan).
// Every width <= kF64Width. Returns the CUDA error code of the launches (0
// on success).
extern "C" int pinns_taylor2_backward_f64(const double* x, int n, const double* params,
                                          const int* dims, int n_layers, double lb0, double lb1,
                                          double ub0, double ub1, int grid, const double* gu,
                                          const double* gux, const double* gut,
                                          const double* guxx, double* partials, double* pstore,
                                          double* grad, int device, void* stream) {
  using namespace k2d;
  if (n < 1 || n_layers < 1 || n_layers > kF64MaxLayers || dims[0] != 2 || grid < 1 ||
      grid > (n + kF64Tile - 1) / kF64Tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NetF64 net;
  net.n_layers = n_layers;
  int widest = 0;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kF64Width) return static_cast<int>(cudaErrorInvalidValue);
    net.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net.w_off[l] = off;
    off += static_cast<long long>(dims[l]) * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
  }
  net.n_params = off;
  net.max_width = widest;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = k2d::smem_bytes(widest);
  err = cudaFuncSetAttribute(k2d::backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k2d::backward_kernel<<<grid, kF64Threads, smem, st>>>(x, n, params, net, lb0, lb1, ub0, ub1,
                                                        gu, gux, gut, guxx, partials, pstore);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2d::reduce_kernel<<<static_cast<unsigned>((off + 255) / 256), 256, 0, st>>>(partials, grid,
                                                                                 off, grad);
  return static_cast<int>(cudaGetLastError());
}
