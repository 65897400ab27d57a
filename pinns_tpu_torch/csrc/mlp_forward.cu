// Fused forward of the domain-normalized tanh MLP, and its hand-written
// backward, for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel `mlp_forward_pallas` / `_forward_kernel`
// (pinns_tpu/ops/pallas/fused_mlp.py at git 89afc4b^, lines 92-146), which
// computed u = W_L tanh(... tanh(W_0 normalize(x) + b_0) ...) + b_L in one
// pass and had no VJP. The port differentiates the data misfit of the
// training loss on the card, so this file also holds the backward: the
// cotangent of u -> dW, db of every layer:
//   dW_l = X_l^T G_l        db_l = sum over points of G_l
//   G_{l-1} = (1 - X_l^2) (G_l W_l^T)
// with X_l the input of layer l (the tanh output of layer l-1) and G_l the
// adjoint of layer l's pre-activation (the cotangent at the head).
// ops/kernels/mlp_forward.py::mlp_backward_reference is this algorithm in
// plain PyTorch, held against torch.autograd and jax.grad by the CPU tests.
// Two designs, picked from the widths by ops/kernels/mlp_forward.py::design;
// neither uses atomics, so two calls agree bit for bit.
//
// Narrow (every width <= 32: the 8x20 nets of burgers_forward and
// abgrall_admm, on host-bound paths where launches cost more than FMAs).
// Forward (forward_kernel): one block per tile of points; the activations of
// the current layer stay in shared memory as [unit][point], point fastest,
// ping-ponged between two buffers. A thread owns one output unit and 4
// consecutive points: one float4 load and 4 FMAs per weight it reads.
// Backward (backward_kernel, then reduce_kernel): block b walks the tiles
// b, b + grid, ...; per tile it runs the forward again, writing each hidden
// layer's output to a per-block global scratch, seeds the head with the
// cotangent and goes back layer by layer in shared memory, adding its tiles
// into its own row of partial gradients; reduce_kernel sums the rows in
// block order, one thread per parameter. The float64 mode (`polish` on the
// card: pinns_mlp_forward_f64, pinns_mlp_backward_f64) is this design
// instantiated on double; the wide design stays float32.
//
// Wide (any wider net: burgers_scale's 8x200, the Euler trunk 2x200x5x3).
// The whole call, layer by layer, as dense products over all its points on
// the engine of layer_gemm.cuh (K2's), with a block tile that the plan
// (mlp_backward_plan) picks from the number of points: 32 x 32 tiles of 64
// threads (4 x 4 register tiles) spread a call of a few hundred points over
// many SMs; 128 x 128 tiles of 256 threads (8 x 8 register tiles, K2's) feed
// the FMAs best at tens of thousands. Points are padded to n_pad, a multiple
// of the 128-point row tile, with the point (0, 0) and a zero cotangent.
// Every input H_l carries one more column, 1, so that the flat [W_l; b_l]
// (b_l follows W_l in pack_params order) is one (din + 1) x dout matrix:
//   forward   an input pass writes H_0 = [x^, t^, 1, 0]; per hidden layer
//             one product H_l+1 = tanh(H_l [W_l; b_l]) with the tanh and the
//             next indicator in its epilogue; the head, u = H_L-1 [W; b],
//             on the small tile (1-3 columns). The wide forward and the
//             backward's recompute run the same code, so the backward sees
//             the forward's activations bit for bit;
//   backward  the forward again, keeping every hidden output; the head's
//             adjoints seeded with the cotangent; per layer, head first, one
//             launch of two products, dW_l = H_l^T G (TN, split over row
//             chunks of at most 1,024 rows into per-split partials) and gH =
//             G W_l^T (NT, split over its depth into partials where a call
//             has few rows); one elementwise pass that sums gH's partials in
//             order and writes G_l-1 = (1 - H_l^2) gH, summing it per
//             128-point tile in double (db_l-1); then wide_reduce_kernel: one
//             thread per parameter, in double, a weight's partials and a
//             bias's per-tile sums, each in a fixed order.
// Fourier and shock-path features (wide design only; csrc/fourier.cuh,
// csrc/paths.cuh): with F Fourier features and K paths the input pass writes
// H_0 = [x^, t^, sin z_1..F, cos z_1..F, phi_1 .. phi_K, 1, 0 ...] from B
// (by value) and from path_c and path_a (after the trunk in the flat
// params). B is fixed, so the Fourier features need no backward; with paths
// the backward takes layer
// 0's gH = G W_0^T in the launch of its dW, and one pass with a thread a
// point applies the paths' chain rule to gH's path columns, summing per
// 128-point block in double, which the reduction sums in block order (one
// launch more).
// 28 launches for the backward of the 8x200 net, 10 for its forward, all
// from one host call on the caller's stream. The caller allocates the
// scratch, one buffer that the launcher lays out and checks against its
// size. Every kernel here is in namespace k5, and the engine's kernels are
// instantiated on K5's own tile types, so a profile tells them from K2's.
//
// What bounds it on the H100: at the data term's 100 points, latency: the
// chain of dependent launches and each product's 26-stage pipeline, about
// 56 MFLOP a backward call. At 8x200 and tens of thousands of points the
// fp32 FMA rate of the products (no tensor cores: the port keeps full fp32),
// as for K2 (37-41% of the fp32 peak there; PERF.md, Findings).

#include <cuda_runtime.h>
#include <stddef.h>

#include "layer_gemm.cuh"
#include "paths.cuh"

namespace {
namespace k5 {

constexpr int kR = 4;              // points per thread item (one float4)
constexpr int kFwdThreads = 640;   // forward block size bound
constexpr int kFwdThreadsF64 = 256;  // the float64 mode's forward bound (double registers)
constexpr int kBwdThreads = 256;   // backward block size

// -- the narrow design --------------------------------------------------------
// Every function of it is a template on the scalar type R: float for K5,
// double for K5's float64 mode (`polish`'s data term and evaluation on the
// card), the same arithmetic with __fma_rn and double tanh, 8-byte values in
// the same layout (two double2 loads where float reads one float4).

template <typename R>
struct NarrowBox {
  R lb0, lb1, ub0, ub1;
};

// Four consecutive values (16-byte aligned: rows of tile + 4 values).
template <typename R>
__device__ __forceinline__ void ld4v(const R* p, R (&v)[kR]) {
  if constexpr (sizeof(R) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

template <typename R>
__device__ __forceinline__ void st4(R* p, const R (&v)[kR]) {
  if constexpr (sizeof(R) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
}

__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float tanh_of(float a) { return tanhf(a); }
__device__ __forceinline__ double tanh_of(double a) { return tanh(a); }

// Normalized (x, t) of the tile's points into rows 0 and 1 of buf; zero for
// the slots past n.
template <typename R>
__device__ __forceinline__ void load_inputs(R* buf, int ts, const R* __restrict__ x, int n,
                                            long long p0, int tile, const NarrowBox<R>& box) {
  const R rx = box.ub0 - box.lb0, rt = box.ub1 - box.lb1;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    R xv = R(0), tv = R(0);
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    buf[0 * ts + p] = R(2) * (xv - box.lb0) / rx - R(1);
    buf[1 * ts + p] = R(2) * (tv - box.lb1) / rt - R(1);
  }
}

// a[r] = sum_k in[k][pc + r] W[k][j]: unit j of a dense layer at 4 points.
template <typename R>
__device__ __forceinline__ void dense4(const R* in, int ts, const R* __restrict__ W,
                                       int din, int dout, int j, int pc, R (&a)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) a[r] = R(0);
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const R w = __ldg(W + k * dout + j);
    R h[kR];
    ld4v(in + k * ts + pc, h);
#pragma unroll
    for (int r = 0; r < kR; ++r) a[r] = fma_of(h[r], w, a[r]);
  }
}

// The hidden layers of a tile whose inputs are in `in`, ping-ponging with
// `out`. Writes each hidden layer's output to `store` ([layer][unit][tile])
// when it is not null. Returns the buffer holding the last hidden output.
template <typename R>
__device__ R* hidden_forward(const Net& net, const R* __restrict__ params, R* in, R* out,
                             int tile, int ts, R* __restrict__ store) {
  const int groups = tile / kR;
  for (int l = 0; l < net.n_layers - 1; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const R* __restrict__ W = params + net.w_off[l];
    const R* __restrict__ b = params + net.b_off[l];
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      R a[kR];
      dense4(in, ts, W, din, dout, j, pc, a);
      const R bj = b[j];
      R s[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r] = tanh_of(a[r] + bj);
      st4(out + j * ts + pc, s);
      if (store != nullptr) {
        st4(store + (static_cast<long long>(l) * net.max_width + j) * tile + pc, s);
      }
    }
    __syncthreads();
    R* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

template <typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kFwdThreads : kFwdThreadsF64)
forward_kernel(const R* __restrict__ x, int n, const R* __restrict__ params, Net net,
               NarrowBox<R> box, int tile, R* __restrict__ u) {
  extern __shared__ float4 smem4[];
  R* bufA = reinterpret_cast<R*>(smem4);
  const int ts = tile + 4;  // row stride, padded against bank conflicts
  R* bufB = bufA + net.max_width * ts;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  load_inputs(bufA, ts, x, n, p0, tile, box);
  __syncthreads();
  const R* X = hidden_forward(net, params, bufA, bufB, tile, ts, static_cast<R*>(nullptr));
  const int l = net.n_layers - 1;
  const int din = net.dims[l], dout = net.dims[l + 1];
  const R* __restrict__ W = params + net.w_off[l];
  const R* __restrict__ b = params + net.b_off[l];
  for (int item = threadIdx.x; item < (tile / kR) * dout; item += blockDim.x) {
    const int g = item / dout;
    const int j = item - g * dout;
    const int pc = g * kR;
    R a[kR];
    dense4(X, ts, W, din, dout, j, pc, a);
    const R bj = b[j];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long gp = p0 + pc + r;
      if (gp < n) u[gp * dout + j] = a[r] + bj;
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kBwdThreads)
backward_kernel(const R* __restrict__ x, int n, const R* __restrict__ params, Net net,
                NarrowBox<R> box, int tile, const R* __restrict__ gout, R* __restrict__ partials,
                R* __restrict__ hstore) {
  extern __shared__ float4 smem4[];
  R* smem = reinterpret_cast<R*>(smem4);
  const int T = tile, ts = T + 4;
  const int plane = net.max_width * ts;
  R* X = smem;           // the input activations of the current layer
  R* G0 = smem + plane;  // adjoints: this layer's, then the layer below's
  R* Y0 = smem + 2 * plane;
  const int L = net.n_layers;
  const int d_head = net.dims[L];
  R* store = hstore + static_cast<long long>(blockIdx.x) * (L - 1) * net.max_width * T;
  R* part = partials + static_cast<long long>(blockIdx.x) * net.n_params;
  const int n_tiles = (n + T - 1) / T;
  const int groups = T / kR;

  for (int tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const bool first = tix == static_cast<int>(blockIdx.x);
    const long long p0 = static_cast<long long>(tix) * T;
    load_inputs(X, ts, x, n, p0, T, box);
    __syncthreads();
    hidden_forward(net, params, X, Y0, T, ts, store);
    R* G = G0;
    R* Y = Y0;
    for (int e = threadIdx.x; e < d_head * T; e += blockDim.x) {
      const int j = e / T, t = e - j * T;
      G[j * ts + t] = p0 + t < n ? gout[(p0 + t) * d_head + j] : R(0);
    }
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      if (l == 0) {
        load_inputs(X, ts, x, n, p0, T, box);
      } else {
        const R* S = store + static_cast<long long>(l - 1) * net.max_width * T;
        for (int e = threadIdx.x; e < din * T; e += blockDim.x) {
          const int k = e / T, t = e - k * T;
          X[k * ts + t] = S[k * T + t];
        }
      }
      __syncthreads();
      const R* __restrict__ W = params + net.w_off[l];
      const int n_w = din * dout + dout;
      const int n_items = n_w + (l > 0 ? din * groups : 0);
      for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        if (item < din * dout) {
          // dW[k][j] = sum_t X[k][t] G[j][t]
          const int k = item / dout, j = item - k * dout;
          R acc = R(0);
          for (int t = 0; t < T; t += kR) {
            R xv[kR], gv[kR];
            ld4v(X + k * ts + t, xv);
            ld4v(G + j * ts + t, gv);
#pragma unroll
            for (int r = 0; r < kR; ++r) acc = fma_of(xv[r], gv[r], acc);
          }
          const int o = net.w_off[l] + item;
          part[o] = first ? acc : part[o] + acc;
        } else if (item < n_w) {
          // db[j] = sum_t G[j][t]
          const int j = item - din * dout;
          R acc = R(0);
          for (int t = 0; t < T; ++t) acc += G[j * ts + t];
          const int o = net.b_off[l] + j;
          part[o] = first ? acc : part[o] + acc;
        } else {
          // the adjoint of layer l-1's pre-activation at 4 points
          const int e = item - n_w;
          const int g = e / din, k = e - g * din;
          const int pc = g * kR;
          R gh[kR] = {R(0), R(0), R(0), R(0)};
          for (int j = 0; j < dout; ++j) {
            const R w = __ldg(W + k * dout + j);
            R gv[kR];
            ld4v(G + j * ts + pc, gv);
#pragma unroll
            for (int r = 0; r < kR; ++r) gh[r] = fma_of(gv[r], w, gh[r]);
          }
          R xv[kR];
          ld4v(X + k * ts + pc, xv);
          R o[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const R s = xv[r];
            o[r] = (R(1) - s * s) * gh[r];
          }
          st4(Y + k * ts + pc, o);
        }
      }
      __syncthreads();
      R* tmp = G;
      G = Y;
      Y = tmp;
    }
  }
}

// One thread per parameter: the partial rows summed in block order.
template <typename R>
__global__ void reduce_kernel(const R* __restrict__ partials, int rows, int n_params,
                              R* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  R s = R(0);
  for (int b = 0; b < rows; ++b) s += partials[static_cast<long long>(b) * n_params + i];
  grad[i] = s;
}

// Dynamic shared memory: `buffers` x max_width rows x (tile + 4) values of
// `item` bytes (ops/kernels/mlp_forward.py::smem_bytes).
size_t smem_bytes(int buffers, int max_width, int tile, size_t item = sizeof(float)) {
  return item * static_cast<size_t>(buffers) * static_cast<size_t>(max_width) *
         static_cast<size_t>(tile + 4);
}

// The narrow forward's launch on R (float: pinns_mlp_forward; double:
// pinns_mlp_forward_f64).
template <typename R>
int narrow_forward(const R* x, int n, const R* params, const int* dims, int n_layers, R lb0,
                   R lb1, R ub0, R ub1, int tile, int threads, R* u, int device, void* stream) {
  const int max_threads = sizeof(R) == 4 ? kFwdThreads : kFwdThreadsF64;
  Net net;
  if (n < 0 || !make_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 ||
      threads < 32 || threads > max_threads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(2, net.max_width, tile, sizeof(R));
  err = cudaFuncSetAttribute(forward_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const NarrowBox<R> box{lb0, lb1, ub0, ub1};
  const unsigned blocks = static_cast<unsigned>((n + tile - 1) / tile);
  forward_kernel<R><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, params, net, box, tile, u);
  return static_cast<int>(cudaGetLastError());
}

// The narrow backward's launches on R (float: pinns_mlp_backward; double:
// pinns_mlp_backward_f64).
template <typename R>
int narrow_backward(const R* x, int n, const R* params, const int* dims, int n_layers, R lb0,
                    R lb1, R ub0, R ub1, int tile, int grid, const R* gout, R* partials,
                    R* hstore, R* grad, int device, void* stream) {
  Net net;
  if (n < 1 || !make_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 || grid < 1 ||
      grid > (n + tile - 1) / tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(3, net.max_width, tile, sizeof(R));
  err = cudaFuncSetAttribute(backward_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const NarrowBox<R> box{lb0, lb1, ub0, ub1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  backward_kernel<R><<<grid, kBwdThreads, smem, s>>>(x, n, params, net, box, tile, gout,
                                                     partials, hstore);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<R><<<(net.n_params + 255) / 256, 256, 0, s>>>(partials, grid, net.n_params, grad);
  return static_cast<int>(cudaGetLastError());
}


// -- the wide design ----------------------------------------------------------

// The plan's block tiles: 32 x 32 of 64 threads with 4 x 4 register tiles,
// and K2's 128 x 128 of 256 threads with 8 x 8 register tiles.
struct SmallTile : TileCfg<64, 4, 4, 1, 8> {};
struct LargeTile : TileCfg<256, 8, 8, 2, 2> {};
constexpr int kMaxGhSplits = 4;  // ops/kernels/mlp_forward.py::MAX_GH_SPLITS

// The hidden layers' epilogue: H_l+1(m, n) = tanh of the sum (the bias came
// in through H_l's indicator column), and H_l+1's own indicator after its
// last unit.
struct TanhStore {
  static __device__ __forceinline__ void store(float* __restrict__ C, int ldc, int m, int n,
                                               int N, float v) {
    float* row = C + static_cast<long long>(m) * ldc;
    row[n] = tanhf(v);
    if (n == N - 1) row[N] = 1.0f;
  }
};

// H_0 (n_pad x ld_h(2 + 2F + K)): normalized (x, t), the Fourier and the
// path features, the indicator 1 and zeros (write_input_rows); points past
// n at (0, 0).
__global__ void input_kernel(const float* __restrict__ x, int n, int n_pad, Box box,
                             Fourier fo, Paths paths, float* __restrict__ H) {
  const int ld = ld_h(embed_width(fo, paths));
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pad; p += gridDim.x * blockDim.x) {
    float xn, tn;
    normalized_point(x, p, n, box, &xn, &tn);
    write_input_rows(fo, paths, xn, tn, 0.0f, 0.0f, ld, 1, H + static_cast<long long>(p) * ld,
                     nullptr, nullptr, nullptr);
  }
}

// The path gradient's per-block partials (path_grad_block) from gH_0 (n_pad
// x ld_g), the adjoints of H_0's columns, the path columns from 2 + 2F on.
__global__ void path_grad_kernel(const float* __restrict__ x, int n, Box box, int n_fourier,
                                 Paths paths, const float* __restrict__ gh, int ld_g,
                                 double* __restrict__ psums) {
  path_grad_block(x, n, box, paths, gh + 2 + 2 * n_fourier, nullptr, nullptr, nullptr, ld_g,
                  psums);
}

// The head's adjoints G (n_pad x d): the cotangent, zero past n; sums (tiles
// x d) receives their per-tile sums (db of the head).
__global__ void seed_kernel(const float* __restrict__ gout, int n, int d, float* __restrict__ G,
                            double* __restrict__ sums) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  double db = 0.0;
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (j >= d) continue;
    const long long at = p * d + j;
    const float v = p < n ? gout[at] : 0.0f;
    G[at] = v;
    db += v;
  }
  tile_column_sum(db, j, d, sums);
}

// Backward through the tanh of the layer whose output H (n_pad x ld_h(d))
// is: gH, the adjoints of that output, is the sum of `parts` split partials
// (n_pad x d each, `plane` floats apart), taken in split order; G (n_pad x d)
// receives the adjoints of the pre-activation, (1 - H^2) gH, and sums
// (tiles x d) their per-tile sums in double (db).
__global__ void backward_act_kernel(const float* __restrict__ H, const float* __restrict__ gh,
                                    int parts, long long plane, float* __restrict__ G, int d,
                                    double* __restrict__ sums) {
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int ld = ld_h(d);
  double db = 0.0;
  // unrolled, so that a thread's loads are all in flight at once
#pragma unroll
  for (int i = 0; i < kTile / kEwRows; ++i) {
    const long long p = ew_point(i);
    if (j >= d) continue;
    const long long at = p * d + j;
    float g = gh[at];
#pragma unroll
    for (int z = 1; z < kMaxGhSplits; ++z) {
      if (z < parts) g += gh[z * plane + at];
    }
    const float s = H[p * ld + j];
    const float v = (1.0f - s * s) * g;
    G[at] = v;
    db += v;
  }
  tile_column_sum(db, j, d, sums);
}

// One thread a parameter: the trunk's (reduce_param), then the paths' from
// their per-block partials (psums, tiles x n_path).
__global__ void wide_reduce_kernel(const float* __restrict__ partials, int splits,
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

// H_l+1 = tanh(H_l [W_l; b_l]) for the hidden layers from H_0 = h0; hidden
// layer l writes out[l] (n_pad x ld_h(dims[l + 1])). The wide forward and
// the backward's recompute both run it.
template <class Cfg>
cudaError_t hidden_products(const Net& net, const float* params, const float* h0, int n_pad,
                            float* const* out, cudaStream_t s) {
  for (int l = 0; l + 1 < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* W = params + net.w_off[l];
    const Gemm g{l == 0 ? h0 : out[l - 1], W, W, out[l], ld_h(din), dout, ld_h(dout), n_pad,
                 dout, din + 1, din + 1, 0, 1, 0};
    const cudaError_t e = gemm<Cfg, false, false, TanhStore>(g, 1, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// u (n x dims[L]) = the head's product over the last hidden output.
template <class Cfg>
int forward_wide(const float* x, int n, const float* params, const Net& net,
                 const Fourier& fo, const Paths& paths, const Box& box, int n_pad, float* scratch, long long scratch_floats, float* u,
                 cudaStream_t s) {
  Carve c{scratch, 0};
  float* h0 = c.take(static_cast<long long>(n_pad) * ld_h(net.dims[0]));
  const long long plane = static_cast<long long>(n_pad) * ld_h(net.max_width);
  float* hbuf = c.take(2 * plane);
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  float* out[kMaxLayers];
  for (int l = 0; l + 1 < net.n_layers; ++l) out[l] = hbuf + (l % 2) * plane;
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, fo, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  PINNS_CHECK(hidden_products<Cfg>(net, params, h0, n_pad, out, s));
  const int l = net.n_layers - 1, din = net.dims[l], dout = net.dims[l + 1];
  const float* W = params + net.w_off[l];
  const Gemm head{l == 0 ? h0 : out[l - 1], W, W, u, ld_h(din), dout, dout, n, dout, din + 1,
                  din + 1, 0, 1, 0};
  PINNS_CHECK((gemm<SmallTile, false, false>(head, 1, s)));
  return static_cast<int>(cudaSuccess);
}

template <class Cfg>
int backward_wide(const float* x, int n, const float* params, const Net& net,
                  const Fourier& fo, const Paths& paths, const Box& box, int n_pad, int split_rows, int splits,
                  int gh_splits, const float* gout, float* scratch, long long scratch_floats,
                  float* grad, cudaStream_t s) {
  const int L = net.n_layers, tiles = n_pad / kTile;
  // hidden layer l's output at hstore + h_off[l]; the per-tile db sums of
  // layer l at sums + l tiles max_width
  long long h_off[kMaxLayers];
  long long h_end = 0;
  for (int l = 0; l + 1 < L; ++l) {
    h_off[l] = h_end;
    h_end += static_cast<long long>(n_pad) * ld_h(net.dims[l + 1]);
  }
  const long long sums_stride = static_cast<long long>(tiles) * net.max_width;
  Carve c{scratch, 0};
  double* sums = reinterpret_cast<double*>(c.take(2 * L * sums_stride));
  float* h0 = c.take(static_cast<long long>(n_pad) * ld_h(net.dims[0]));
  float* hstore = c.take(h_end);
  const long long plane = static_cast<long long>(n_pad) * net.max_width;
  float* G = c.take(plane);
  float* gh_parts = c.take(gh_splits * plane);
  float* partials = c.take(static_cast<long long>(splits) * net.n_params);
  double* psums = reinterpret_cast<double*>(c.take(2LL * tiles * paths.n_params()));
  if (c.used > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  float* H[kMaxLayers];
  for (int l = 0; l + 1 < L; ++l) H[l] = hstore + h_off[l];
  input_kernel<<<ew_blocks(n_pad), kEwThreads, 0, s>>>(x, n, n_pad, box, fo, paths, h0);
  PINNS_CHECK(cudaGetLastError());
  PINNS_CHECK(hidden_products<Cfg>(net, params, h0, n_pad, H, s));

  // head first: G holds the adjoints of layer l's pre-activation; the layer's
  // gH goes to gh_parts, from which the tanh's backward writes the layer
  // below's into G
  const dim3 ew_block(32, kEwRows);
  seed_kernel<<<dim3((net.dims[L] + 31) / 32, tiles), ew_block, 0, s>>>(
      gout, n, net.dims[L], G, sums + (L - 1) * sums_stride);
  PINNS_CHECK(cudaGetLastError());
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* Hl = l == 0 ? h0 : H[l - 1];  // the input of layer l
    // dW_l = H_l^T G over the rows, split into row chunks
    const Gemm dw{Hl, G, G, partials + net.w_off[l], ld_h(din), dout, dout, din, dout, n_pad,
                  split_rows, net.n_params, 1, 0};
    const int dw_bx = (din + Cfg::kBM - 1) / Cfg::kBM, dw_by = (dout + Cfg::kBN - 1) / Cfg::kBN;
    if (l == 0 && paths.k == 0) {
      PINNS_CHECK((gemm<Cfg, true, false>(dw, splits, s)));
      break;
    }
    // with gH = G W_l^T, its sum over dout split into gh_splits chunks of
    // whole depth tiles (layer 0's, the adjoints of the path features, in
    // one chunk)
    const float* W = params + net.w_off[l];
    const int parts = l == 0 ? 1 : gh_splits;
    const int gh_k = (dout + parts * kDepth - 1) / (parts * kDepth) * kDepth;
    const Gemm gh{G, W, W, gh_parts, dout, dout, din, n_pad, din, dout, gh_k, plane, 1, 0};
    const int gh_bx = (n_pad + Cfg::kBM - 1) / Cfg::kBM, gh_by = (din + Cfg::kBN - 1) / Cfg::kBN;
    gemm_pair_kernel<Cfg, true>
        <<<dw_bx * dw_by * splits + gh_bx * gh_by * parts, Cfg::kThreads, 0, s>>>(
            dw, dw_bx, dw_by, splits, gh, gh_bx, gh_by);
    PINNS_CHECK(cudaGetLastError());
    if (l == 0) {
      path_grad_kernel<<<tiles, kTile, kTile * sizeof(double), s>>>(x, n, box, fo.f, paths,
                                                                    gh_parts, din, psums);
      PINNS_CHECK(cudaGetLastError());
      break;
    }
    backward_act_kernel<<<dim3((din + 31) / 32, tiles), ew_block, 0, s>>>(
        Hl, gh_parts, gh_splits, plane, G, din, sums + (l - 1) * sums_stride);
    PINNS_CHECK(cudaGetLastError());
  }
  const int n_path = paths.n_params();
  wide_reduce_kernel<<<(net.n_params + n_path + 255) / 256, 256, 0, s>>>(
      partials, splits, sums, tiles, net, psums, n_path, grad);
  return static_cast<int>(cudaGetLastError());
}

// The checks both wide launchers make of a plan (n >= 1): a padding that is
// a whole number of row tiles, a tile the file instantiates, an aligned
// scratch, Fourier features and paths within bounds and an input width 2 +
// 2 n_fourier + n_paths, operands that 32-bit offsets reach.
bool wide_plan_ok(const int* dims, int n_layers, int n_fourier, int n_paths, int path_degree,
                  int n, int n_pad, int tile, const float* scratch, Net* net) {
  if (n < 1 || n_pad < n || n_pad % kTile != 0 || n_pad / kTile > 65535 ||
      (tile != SmallTile::kBM && tile != LargeTile::kBM) ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0 || !paths_ok(n_paths, path_degree) ||
      !fourier_ok(n_fourier) || !make_net(dims, n_layers, net, 2 + 2 * n_fourier + n_paths)) {
    return false;
  }
  return static_cast<long long>(n_pad) * ld_h(net->max_width) <= 0x7fffffffLL;
}

}  // namespace k5

using namespace k5;

}  // namespace

// u = MLP(x) on `stream`. `dims` (host memory) holds n_layers + 1 widths;
// `params` (device) W_0, b_0, W_1, b_1, ... back to back. x is (n, 2), u
// (n, dims[n_layers]), float32, contiguous, on device `device`. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pinns_mlp_forward(const float* x, int n, const float* params, const int* dims,
                                 int n_layers, float lb0, float lb1, float ub0, float ub1,
                                 int tile, int threads, float* u, int device, void* stream) {
  return narrow_forward<float>(x, n, params, dims, n_layers, lb0, lb1, ub0, ub1, tile, threads, u,
                               device, stream);
}

// grad (flat, params order) = d/dparams of sum over points of gout . u, on
// `stream`. gout is (n, dims[n_layers]); `partials` (grid x n_params) and
// `hstore` (grid x (n_layers - 1) x max_width x tile) are scratch. n >= 1.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int pinns_mlp_backward(const float* x, int n, const float* params, const int* dims,
                                  int n_layers, float lb0, float lb1, float ub0, float ub1,
                                  int tile, int grid, const float* gout, float* partials,
                                  float* hstore, float* grad, int device, void* stream) {
  return narrow_backward<float>(x, n, params, dims, n_layers, lb0, lb1, ub0, ub1, tile, grid,
                                gout, partials, hstore, grad, device, stream);
}

// K5's float64 mode, the narrow design in double (arguments as the float32
// entry points, every pointer and the box in double; the forward's threads
// at most kFwdThreadsF64).
extern "C" int pinns_mlp_forward_f64(const double* x, int n, const double* params,
                                     const int* dims, int n_layers, double lb0, double lb1,
                                     double ub0, double ub1, int tile, int threads, double* u,
                                     int device, void* stream) {
  return narrow_forward<double>(x, n, params, dims, n_layers, lb0, lb1, ub0, ub1, tile, threads,
                                u, device, stream);
}

extern "C" int pinns_mlp_backward_f64(const double* x, int n, const double* params,
                                      const int* dims, int n_layers, double lb0, double lb1,
                                      double ub0, double ub1, int tile, int grid,
                                      const double* gout, double* partials, double* hstore,
                                      double* grad, int device, void* stream) {
  return narrow_backward<double>(x, n, params, dims, n_layers, lb0, lb1, ub0, ub1, tile, grid,
                                 gout, partials, hstore, grad, device, stream);
}

// The wide design's forward: u = MLP(x), (n, dims[n_layers]), on `stream`.
// dims[0] = 2 + 2 n_fourier + n_paths; `fourier` (host) the 2 n_fourier
// frequencies, 2 pi B[:, 0] then 2 pi B[:, 1] (csrc/fourier.cuh), null
// without Fourier features; with n_paths > 0 `params` ends with path_c
// (n_paths x (path_degree + 1)) and path_a (n_paths) after the trunk.
// The points are padded to n_pad and the products take the block tile
// `tile` (32 or 128); `scratch` (16-byte aligned, scratch_floats floats)
// holds, each part on 16 bytes, h0 (n_pad x ld_h(dims[0])) and two hidden outputs
// (n_pad x ld_h(max_width) each). ops/kernels/mlp_forward.py::
// mlp_forward_plan computes the same plan; one that does not fit this layout
// is refused with cudaErrorInvalidValue. Returns the CUDA error code of the
// first launch that failed (0 on success).
extern "C" int pinns_mlp_forward_wide(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, int n_fourier,
                                      const float* fourier, int n_paths,
                                      int path_degree, float lb0, float lb1, float ub0,
                                      float ub1, int n_pad, int tile, float* scratch,
                                      long long scratch_floats, float* u, int device,
                                      void* stream) {
  Net net;
  if (!wide_plan_ok(dims, n_layers, n_fourier, n_paths, path_degree, n, n_pad, tile, scratch,
                    &net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(cudaSetDevice(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  const Fourier fo = make_fourier(n_fourier, fourier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? forward_wide<SmallTile>(x, n, params, net, fo, paths, box, n_pad, scratch,
                                       scratch_floats, u, s)
             : forward_wide<LargeTile>(x, n, params, net, fo, paths, box, n_pad, scratch,
                                       scratch_floats, u, s);
}

// The wide design's backward: grad (flat, params order) = d/dparams of sum
// over points of gout . u, on `stream`; gout is (n, dims[n_layers]), the
// arguments as the forward's; grad has the trunk's parameters, then the
// paths'. dW's sum over the n_pad rows is cut into `splits` chunks of
// split_rows (whole depth tiles), gH's over a layer's dout into gh_splits
// chunks; `scratch` holds, in this order and each part on 16 bytes: sums,
// n_layers x tiles x max_width doubles (tiles = n_pad / 128); h0, n_pad x
// ld_h(dims[0]); the hidden outputs, n_pad x ld_h(dims[l + 1]) each in layer
// order; G and gH's partials, 1 + gh_splits planes of n_pad x max_width;
// partials, splits x the trunk's n_params; psums, tiles x n_paths
// (path_degree + 2) doubles.
// ops/kernels/mlp_forward.py::mlp_backward_plan computes the same plan; one
// that does not fit this layout (a split that does not cover the rows
// exactly, a smaller scratch, ...) is refused with cudaErrorInvalidValue.
extern "C" int pinns_mlp_backward_wide(const float* x, int n, const float* params,
                                       const int* dims, int n_layers, int n_fourier,
                                       const float* fourier, int n_paths,
                                       int path_degree, float lb0, float lb1, float ub0,
                                       float ub1, int n_pad, int tile, int split_rows,
                                       int splits, int gh_splits, const float* gout,
                                       float* scratch, long long scratch_floats, float* grad,
                                       int device, void* stream) {
  Net net;
  if (!wide_plan_ok(dims, n_layers, n_fourier, n_paths, path_degree, n, n_pad, tile, scratch,
                    &net) ||
      split_rows < 1 ||
      split_rows % kDepth != 0 || splits < 1 || splits > 65535 || gh_splits < 1 ||
      gh_splits > kMaxGhSplits ||
      static_cast<long long>(splits) * split_rows < n_pad ||
      static_cast<long long>(splits - 1) * split_rows >= n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PINNS_CHECK(cudaSetDevice(device));
  const Box box{lb0, lb1, ub0, ub1};
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  const Fourier fo = make_fourier(n_fourier, fourier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == SmallTile::kBM
             ? backward_wide<SmallTile>(x, n, params, net, fo, paths, box, n_pad, split_rows,
                                        splits, gh_splits, gout, scratch, scratch_floats, grad,
                                        s)
             : backward_wide<LargeTile>(x, n, params, net, fo, paths, box, n_pad, split_rows,
                                        splits, gh_splits, gout, scratch, scratch_floats, grad,
                                        s);
}

extern "C" const char* pinns_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
