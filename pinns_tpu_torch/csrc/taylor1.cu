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
// Design: K2's whole-call layer products (csrc/taylor2_backward.cu) with
// three streams and no second-order term, on the engine of layer_gemm.cuh.
// For each layer the streams are stacked stream-major into one row-major
// (3 n_pad x width) matrix: rows [s n_pad, (s + 1) n_pad) hold stream s
// (value, x, t) of the points 0..n_pad-1, n_pad a multiple of the 128-point
// row tile, so that no product tile straddles two streams. Padded points take
// the streams of the point (0, 0) and a zero cotangent. Every stacked input H
// carries one more column, 1 on value rows and 0 on derivative rows, so that
// the flat [W_l; b_l] (b_l follows W_l in pack_params order) is one
// (din + 1) x dout matrix and P = H [W; b] adds the bias to value rows only.
//   forward   an input pass writes H_0; per hidden layer one product
//             P = H [W; b] and one elementwise pass that writes the next H
//             by the rule above; the head's product, once a stream, into y,
//             y_x, y_t. 4 + 2 (L - 1) launches for L layers (14 at the Euler
//             trunk 2x200x5x3);
//   backward  the forward again, keeping P of every hidden layer; the head's
//             adjoints seeded with the cotangents; per layer, head first, one
//             launch of two products, dW_l = H_l^T G (TN, split over row
//             chunks into per-split partials) and gH = G W_l^T (NT), and one
//             pass that applies the rule's adjoint at P_l-1, sums the value
//             rows' adjoints per 128-point tile in double (db) and recomputes
//             H_l-1 for the next dW; then one thread per parameter sums, in
//             double and in a fixed order, a weight's partials or a bias's
//             per-tile sums. 4 + 4 (L - 1) launches (24 at the Euler trunk).
// Shock-path features (csrc/paths.cuh; pinns_tpu/models/mlp.py:242-291):
// with K paths, H_0's rows become [x^, t^, phi_1 .. phi_K, 1, 0 ...] and the
// tangent rows carry each point's phi_x and phi_t, computed in the input pass
// from path_c and path_a (after the trunk in the flat params), so that
// [W_0; b_0] has 2 + K + 1 rows. The backward then takes layer 0's gH too,
// in the launch of its dW, and one pass with a thread a point applies the
// paths' chain rule to gH's path columns of the three streams, summing per
// 128-point block in double; the reduction sums the blocks in order. The
// forward's launches stay as they are; the backward takes one more (25 at
// the Euler trunk).
// No atomics, so two calls agree bit for bit. Every launch goes on the
// caller's stream from one host call. The caller allocates the scratch, one
// buffer that the launcher lays out and checks against its size
// (ops/kernels/taylor1.py::taylor1_plan). The block tile is the plan's:
// 32 x 32 of 64 threads (4 x 4 register tiles) for a few thousand points, so
// that a call of the Euler batch's 1,000 points spreads over many SMs, K2's
// 128 x 128 of 256 threads (8 x 8) from about one such block an SM. Products
// stay float32 FMA (TF32 is barred by the numerics rule). Every kernel is in
// namespace k7, so a profile tells them from K2's and K5's.
//
// What bounds it on the H100: the operations of the products. At the Euler
// trunk a point's three streams take 161,000 multiply-adds each through the
// layers: about 0.97 MFLOP a point forward and three times that backward
// (forward again, dW and gH), so at N 1,000 0.97 GFLOP forward, 0.014 ms at
// 67 TFLOP/s, where the chain of dependent launches (latency) is what the
// call waits on; at N 65,536 63 GFLOP forward, 0.94 ms.

#include <cuda_runtime.h>
#include <stddef.h>

#include "layer_gemm.cuh"
#include "paths.cuh"

namespace {
namespace k7 {

constexpr int kStreams = 3;
struct SmallTile : TileCfg<64, 4, 4, 1, 8> {};
struct LargeTile : TileCfg<256, 8, 8, 2, 2> {};

// H_0 (3 n_pad x ld_h(2 + K)): normalized (x, t), the path features, the
// indicator 1 on value rows and zeros; the tangent rows (2/(ub0-lb0), 0,
// phi_x ..) and (0, 2/(ub1-lb1), phi_t ..) (write_input_rows). Points past n
// take the streams of (0, 0).
__global__ void input_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                             Paths paths, float* __restrict__ H) {
  const int ld = ld_h(2 + paths.k);
  const long long sH = static_cast<long long>(n_pad) * ld;
  const float sx = 2.0f / (box.ub0 - box.lb0), st = 2.0f / (box.ub1 - box.lb1);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pad; p += gridDim.x * blockDim.x) {
    float xn, tn;
    normalized_point(x, p, n, box, &xn, &tn);
    float* row = H + static_cast<long long>(p) * ld;
    write_input_rows(paths, xn, tn, sx, st, ld, row, row + sH, row + 2 * sH);
  }
}

// The path gradient's per-block partials (path_grad_block) from gH_0 (3 n_pad
// x ld_g), the adjoints of H_0's columns, the path columns from 2 on.
__global__ void path_grad_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                                 Paths paths, const float* __restrict__ gh, int ld_g,
                                 double* __restrict__ psums) {
  const long long plane = static_cast<long long>(n_pad) * ld_g;
  path_grad_block(x, n, box, paths, gh + 2, gh + plane + 2, gh + 2 * plane + 2, ld_g, psums);
}

// The output streams of a hidden layer at its pre-activations (a, ax, at),
// into row `at` of the three planes of H (sH floats apart).
__device__ __forceinline__ void activate(float a, float ax, float at_, float* __restrict__ H,
                                         long long sH, long long at) {
  const float s = tanhf(a);
  const float d1 = 1.0f - s * s;
  H[at] = s;
  H[sH + at] = d1 * ax;
  H[2 * sH + at] = d1 * at_;
}

// The bias's indicator of row p of a stacked input of width d: 1 on the
// value row, 0 on the derivative rows.
__device__ __forceinline__ void indicator(float* __restrict__ H, long long sH, long long p,
                                          int ld, int d) {
  H[p * ld + d] = 1.0f;
  H[sH + p * ld + d] = 0.0f;
  H[2 * sH + p * ld + d] = 0.0f;
}

// Hidden layer of the forward: P (3 n_pad x d) holds the product's sums; H
// (3 n_pad x ld_h(d)) receives the layer's output streams and indicator.
__global__ void forward_act_kernel(const float* __restrict__ P, int n_pad, int d,
                                   float* __restrict__ H) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sP = static_cast<long long>(n_pad) * d;
  const int ld = ld_h(d);
  const long long sH = static_cast<long long>(n_pad) * ld;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (blockIdx.x == 0 && threadIdx.x == 0) indicator(H, sH, p, ld, d);
    if (j >= d) continue;
    const long long at = p * d + j;
    activate(P[at], P[sP + at], P[2 * sP + at], H, sH, p * ld + j);
  }
}

// Backward through the tanh of hidden layer l: G (3 n_pad x d) holds gH, the
// adjoints of the layer's output streams, and receives those of its
// pre-activation streams P (3 n_pad x d, as the forward stored them); sums
// (tiles x d) receives the per-tile sums of the value adjoints, in double:
// db_l. Unless null, H receives the output streams of layer l - 1,
// recomputed from its pre-activations Pb (3 n_pad x db_w; H 3 n_pad x
// ld_h(db_w)): the input of the product dW_l that the next launch pairs with
// gH of layer l.
__global__ void backward_act_kernel(const float* __restrict__ P, float* __restrict__ G,
                                    int n_pad, int d, double* __restrict__ sums,
                                    const float* __restrict__ Pb, int db_w,
                                    float* __restrict__ H) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long sP = static_cast<long long>(n_pad) * d;
  double db = 0.0;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (j >= d) continue;
    const long long at = p * d + j;
    const float pv = P[at], px = P[sP + at], pt = P[2 * sP + at];
    const float s = tanhf(pv);
    const float d1 = 1.0f - s * s;
    const float gh = G[at], ghx = G[sP + at], ght = G[2 * sP + at];
    const float gp = d1 * (gh - 2.0f * s * (ghx * px + ght * pt));
    G[sP + at] = ghx * d1;
    G[2 * sP + at] = ght * d1;
    G[at] = gp;
    db += gp;
  }
  tile_column_sum(db, j, d, sums);
  if (H == nullptr) return;
  const long long sPb = static_cast<long long>(n_pad) * db_w;
  const int ld = ld_h(db_w);
  const long long sH = static_cast<long long>(n_pad) * ld;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (blockIdx.x == 0 && threadIdx.x == 0) indicator(H, sH, p, ld, db_w);
    for (int c = j; c < db_w; c += gridDim.x * 32) {
      const long long at = p * db_w + c;
      activate(Pb[at], Pb[sPb + at], Pb[2 * sPb + at], H, sH, p * ld + c);
    }
  }
}

// The head's adjoints G (3 n_pad x d): the given cotangents, zero past n;
// sums (tiles x d) receives the per-tile sums of the value cotangents.
__global__ void seed_kernel(const float* __restrict__ g0, const float* __restrict__ g1,
                            const float* __restrict__ g2, int n, int n_pad, int d,
                            float* __restrict__ G, double* __restrict__ sums) {
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
    db += v;
  }
  tile_column_sum(db, j, d, sums);
}

// One thread a parameter: the trunk's (reduce_param), then the paths' from
// their per-block partials (psums, tiles x n_path).
__global__ void reduce_kernel(const float* __restrict__ partials, int splits,
                              const double* __restrict__ sums, int tiles, Net net,
                              const double* __restrict__ psums, int n_path,
                              float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < net.n_params) {
    reduce_param(i, partials, splits, sums, tiles, net, grad);
  } else if (i < net.n_params + n_path) {
    grad[i] = path_grad_sum(psums, tiles, n_path, i - net.n_params);
  }
}

// The hidden layers of the forward from H_0 = h0: layer l's product into
// P(l) (P(l) = pstore + p_off[l]), then its pass into hbuf. On return hbuf
// holds the last hidden layer's output streams (h0 for a net without one).
template <class Cfg, class POf>
int hidden_layers(const Net& net, const float* params, const float* h0, int n_pad, POf P,
                  float* hbuf, cudaStream_t s) {
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  const dim3 ew_block(32, kEwRows);
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* W = params + net.w_off[l];
    const Gemm g{l == 0 ? h0 : hbuf, W, W, P(l), ld_h(din), dout, dout, static_cast<int>(rows),
                 dout, din + 1, din + 1, 0, n_pad, 0};
    PINNS_CHECK((gemm<Cfg, false, false>(g, 1, s)));
    forward_act_kernel<<<dim3((dout + 31) / 32, n_pad / kTile), ew_block, 0, s>>>(P(l), n_pad,
                                                                                  dout, hbuf);
    PINNS_CHECK(cudaGetLastError());
  }
  return static_cast<int>(cudaSuccess);
}

// The checks both launchers make of a plan (n >= 1): a padding that is a
// whole number of row tiles, a tile the file instantiates, an aligned
// scratch, paths within bounds and an input width 2 + n_paths, operands that
// 32-bit offsets reach.
bool plan_ok(const int* dims, int n_layers, int n_paths, int path_degree, int n, int n_pad,
             int tile, const float* scratch, Net* net) {
  if (n < 1 || n_pad < n || n_pad % kTile != 0 || n_pad / kTile > 65535 ||
      (tile != SmallTile::kBM && tile != LargeTile::kBM) ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0 || !paths_ok(n_paths, path_degree) ||
      !make_net(dims, n_layers, net, 2 + n_paths)) {
    return false;
  }
  return static_cast<long long>(kStreams) * n_pad * ld_h(net->max_width) <= 0x7fffffffLL;
}

template <class Cfg>
int forward(const float* x, int n, const float* params, const Net& net, const Paths& paths,
            const Box& box, int n_pad, float* scratch, long long scratch_floats, float* y,
            float* y_x, float* y_t, cudaStream_t s) {
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  Carve c{scratch, 0};
  float* h0 = c.take(rows * ld_h(net.dims[0]));
  float* pbuf = c.take(rows * net.max_width);
  float* hbuf = c.take(rows * ld_h(net.max_width));
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  const int err = hidden_layers<Cfg>(net, params, h0, n_pad, [&](int) { return pbuf; }, hbuf, s);
  if (err != 0) return err;
  // the head, one product a stream: its rows [s n_pad, s n_pad + n) of the
  // last stacked input into y, y_x, y_t
  const int l = net.n_layers - 1, din = net.dims[l], dout = net.dims[l + 1];
  const float* W = params + net.w_off[l];
  const float* last = l == 0 ? h0 : hbuf;
  float* outs[kStreams] = {y, y_x, y_t};
  for (int st = 0; st < kStreams; ++st) {
    const Gemm head{last + static_cast<long long>(st) * n_pad * ld_h(din), W, W, outs[st],
                    ld_h(din), dout, dout, n, dout, din + 1, din + 1, 0, 1, 0};
    PINNS_CHECK((gemm<SmallTile, false, false>(head, 1, s)));
  }
  return static_cast<int>(cudaSuccess);
}

template <class Cfg>
int backward(const float* x, int n, const float* params, const Net& net, const Paths& paths,
             const Box& box, int n_pad, int split_rows, int splits, const float* gy,
             const float* gyx, const float* gyt, float* scratch, long long scratch_floats,
             float* grad, cudaStream_t s) {
  const int L = net.n_layers, tiles = n_pad / kTile;
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  // P of hidden layer l at pstore + p_off[l]; the per-tile db sums of layer
  // l at sums + l tiles max_width
  long long p_off[kMaxLayers];
  long long p_end = 0;
  for (int l = 0; l + 1 < L; ++l) {
    p_off[l] = p_end;
    p_end += rows * net.dims[l + 1];
  }
  const long long sums_stride = static_cast<long long>(tiles) * net.max_width;
  Carve c{scratch, 0};
  double* sums = reinterpret_cast<double*>(c.take(2 * L * sums_stride));
  float* h0 = c.take(rows * ld_h(net.dims[0]));
  float* pstore = c.take(p_end);
  float* hbuf = c.take(rows * ld_h(net.max_width));
  float* gbuf = c.take(2 * rows * net.max_width);
  float* partials = c.take(static_cast<long long>(splits) * net.n_params);
  double* psums = reinterpret_cast<double*>(c.take(2LL * tiles * paths.n_params()));
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  const int err = hidden_layers<Cfg>(
      net, params, h0, n_pad, [&](int l) { return pstore + p_off[l]; }, hbuf, s);
  if (err != 0) return err;

  // head first: G holds the adjoints of layer l's pre-activation streams,
  // Gn receives gH; hbuf holds H_l, the input streams of layer l
  const dim3 ew_block(32, kEwRows);
  float* G = gbuf;
  float* Gn = gbuf + rows * net.max_width;
  seed_kernel<<<dim3((net.dims[L] + 31) / 32, tiles), ew_block, 0, s>>>(
      gy, gyx, gyt, n, n_pad, net.dims[L], G, sums + (L - 1) * sums_stride);
  PINNS_CHECK(cudaGetLastError());
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    // dW_l = H_l^T G over the stacked rows, split into row chunks
    const Gemm dw{l == 0 ? h0 : hbuf, G, G, partials + net.w_off[l], ld_h(din), dout, dout, din,
                  dout, static_cast<int>(rows), split_rows, net.n_params, 1, 0};
    const int dw_bx = (din + Cfg::kBM - 1) / Cfg::kBM, dw_by = (dout + Cfg::kBN - 1) / Cfg::kBN;
    if (l == 0 && paths.k == 0) {
      PINNS_CHECK((gemm<Cfg, true, false>(dw, splits, s)));
      break;
    }
    // with gH = G W_l^T (at layer 0 the adjoints of the path features)
    const float* W = params + net.w_off[l];
    const Gemm gh{G, W, W, Gn, dout, dout, din, static_cast<int>(rows), din, dout, dout,
                  0, n_pad, 0};
    const int gh_bx = static_cast<int>((rows + Cfg::kBM - 1) / Cfg::kBM);
    const int gh_by = (din + Cfg::kBN - 1) / Cfg::kBN;
    gemm_pair_kernel<Cfg, false><<<dw_bx * dw_by * splits + gh_bx * gh_by, Cfg::kThreads, 0, s>>>(
        dw, dw_bx, dw_by, splits, gh, gh_bx, gh_by);
    PINNS_CHECK(cudaGetLastError());
    if (l == 0) {
      path_grad_kernel<<<tiles, kTile, kTile * sizeof(double), s>>>(x, n, n_pad, box, paths, Gn,
                                                                    din, psums);
      PINNS_CHECK(cudaGetLastError());
      break;
    }
    // gH -> the adjoints of layer l-1's pre-activations, and H_l-1 for the
    // next dW (layer 0's input streams are h0)
    const int below = net.dims[l - 1];
    backward_act_kernel<<<dim3(((din > below ? din : below) + 31) / 32, tiles), ew_block, 0, s>>>(
        pstore + p_off[l - 1], Gn, n_pad, din, sums + (l - 1) * sums_stride,
        l >= 2 ? pstore + p_off[l - 2] : nullptr, below, l >= 2 ? hbuf : nullptr);
    PINNS_CHECK(cudaGetLastError());
    float* t = G;
    G = Gn;
    Gn = t;
  }
  const int n_path = paths.n_params();
  reduce_kernel<<<(net.n_params + n_path + 255) / 256, 256, 0, s>>>(
      partials, splits, sums, tiles, net, psums, n_path, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7

using namespace k7;

}  // namespace

// (y, y_x, y_t) of the MLP at x on `stream`. `dims` (host) holds n_layers + 1
// widths, dims[0] = 2 + n_paths; `params` (device) W_0, b_0, W_1, b_1, ...
// back to back, then with n_paths > 0 path_c (n_paths x (path_degree + 1))
// and path_a (n_paths). x is (n, 2), each output (n, dims[n_layers]),
// float32, contiguous, on device `device`. The points are padded to n_pad
// and the products take the block tile `tile` (32 or 128); `scratch`
// (16-byte aligned, scratch_floats floats) holds, each part on 16 bytes, h0
// (3 n_pad x ld_h(dims[0])), one layer's
// pre-activations (3 n_pad x max_width) and one layer's stacked inputs
// (3 n_pad x ld_h(max_width)). ops/kernels/taylor1.py::taylor1_plan computes
// the same plan; one that does not fit this layout is refused with
// cudaErrorInvalidValue. Returns the CUDA error code of the first launch
// that failed (0 on success).
extern "C" int pinns_taylor1_forward(const float* x, int n, const float* params, const int* dims,
                                     int n_layers, int n_paths, int path_degree, float lb0,
                                     float lb1, float ub0, float ub1, int n_pad, int tile,
                                     float* scratch, long long scratch_floats, float* y,
                                     float* y_x, float* y_t, int device, void* stream) {
  Net net;
  if (!plan_ok(dims, n_layers, n_paths, path_degree, n, n_pad, tile, scratch, &net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(cudaSetDevice(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? forward<SmallTile>(x, n, params, net, paths, box, n_pad, scratch, scratch_floats,
                                  y, y_x, y_t, s)
             : forward<LargeTile>(x, n, params, net, paths, box, n_pad, scratch, scratch_floats,
                                  y, y_x, y_t, s);
}

// grad (flat, params order) = d/dparams of sum over points of
// gy . y + gyx . y_x + gyt . y_t, on `stream`; the arguments as the
// forward's, with the cotangents (n, dims[n_layers]) each; grad has the
// trunk's parameters, then the paths'. dW's sum over the 3 n_pad stacked
// rows is cut into `splits` chunks of split_rows (a multiple of 32);
// `scratch` holds, in this order and each part on 16 bytes: sums, n_layers x
// tiles x max_width doubles (tiles = n_pad / 128); h0, 3 n_pad x
// ld_h(dims[0]); the pre-activations of every hidden layer (3 n_pad x
// dims[l + 1] each, in layer order); hbuf, 3 n_pad x ld_h(max_width); gbuf,
// 2 x 3 n_pad x max_width; partials, splits x the trunk's n_params; psums,
// tiles x n_paths (path_degree + 2) doubles.
extern "C" int pinns_taylor1_backward(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, int n_paths,
                                      int path_degree, float lb0, float lb1, float ub0,
                                      float ub1, int n_pad, int tile, int split_rows,
                                      int splits, const float* gy, const float* gyx,
                                      const float* gyt, float* scratch,
                                      long long scratch_floats, float* grad, int device,
                                      void* stream) {
  Net net;
  const long long rows = static_cast<long long>(kStreams) * n_pad;
  if (!plan_ok(dims, n_layers, n_paths, path_degree, n, n_pad, tile, scratch, &net) ||
      split_rows < 1 ||
      split_rows % 32 != 0 || splits < 1 || static_cast<long long>(splits) * split_rows < rows ||
      static_cast<long long>(splits - 1) * split_rows >= rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(cudaSetDevice(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? backward<SmallTile>(x, n, params, net, paths, box, n_pad, split_rows, splits, gy,
                                   gyx, gyt, scratch, scratch_floats, grad, s)
             : backward<LargeTile>(x, n, params, net, paths, box, n_pad, split_rows, splits, gy,
                                   gyx, gyt, scratch, scratch_floats, grad, s);
}

extern "C" const char* pinns_taylor1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
