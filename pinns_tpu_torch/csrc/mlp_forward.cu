// Fused forward of the domain-normalized tanh MLP, and its hand-written
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `mlp_forward_pallas` / `_forward_kernel`
// (pinns_tpu/ops/pallas/fused_mlp.py at git 89afc4b^, lines 92-146), which
// computed u = W_L tanh(... tanh(W_0 normalize(x) + b_0) ...) + b_L in one
// pass and had no VJP. The port differentiates the data misfit of the
// training loss on the card, so this file also holds the backward: the
// cotangent of u -> dW, db of every layer.
//
// Forward (forward_kernel). One block per tile of points. The activations of
// the current layer stay in shared memory as [unit][point], point fastest,
// ping-ponged between two buffers; no activation goes back to device memory.
// A thread owns one output unit and 4 consecutive points: one float4 load and
// 4 FMAs per weight it reads. Weights are read row-major from the packed
// parameter buffer (L2-resident).
//
// Backward (backward_kernel, then reduce_kernel). Block b walks the tiles
// b, b + grid, b + 2 grid, ... For each tile it runs the forward again,
// writing each hidden layer's output to a per-block global scratch
// (L2-resident: 35 KB a block at 8x20), seeds the head with the cotangent and
// goes back layer by layer in shared memory:
//   dW_l[k][j] += sum_t X_l[k][t] G_l[j][t]        db_l[j] += sum_t G_l[j][t]
//   G_{l-1}[k][t] = (1 - X_l[k][t]^2) sum_j W_l[k][j] G_l[j][t]
// with X_l the input of layer l (the tanh output of layer l-1) and G_l the
// adjoint of layer l's pre-activation. Block b adds its tiles, in tile order,
// into its own row of partial gradients; reduce_kernel sums the rows in block
// order, one thread per parameter. No atomics: two calls agree bit for bit.
// ops/kernels/mlp_forward.py::mlp_backward_reference is this algorithm in
// plain PyTorch, held against torch.autograd by the CPU tests.
//
// What bounds it on the H100: at 8x20 and the N_u = 100 data points of the
// training loss, latency: one or two blocks, a chain of barrier-separated
// layer phases, one launch forward and two backward. At 8x200 and large N the
// fp32 FMA issue rate of the products (no tensor cores: the port keeps full
// fp32) and, in the backward, the grid x n_params partial rows the reduction
// reads. wgmma, TMA weight staging and a split-K reduction sized to the card
// are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kR = 4;              // points per thread item (one float4)
constexpr int kFwdThreads = 640;   // forward block size bound
constexpr int kBwdThreads = 256;   // backward block size

struct Net {
  int n_layers;
  int max_width;
  int n_params;
  int dims[kMaxLayers + 1];
  int w_off[kMaxLayers];  // offsets of W_l (din x dout, row-major) in the flat params
  int b_off[kMaxLayers];  // offsets of b_l (dout)
};

struct Box {
  float lb0, lb1, ub0, ub1;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[kR]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Normalized (x, t) of the tile's points into rows 0 and 1 of buf; zero for
// the slots past n.
__device__ __forceinline__ void load_inputs(float* buf, int ts, const float* __restrict__ x,
                                            int n, long long p0, int tile, const Box& box) {
  const float rx = box.ub0 - box.lb0, rt = box.ub1 - box.lb1;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    buf[0 * ts + p] = 2.0f * (xv - box.lb0) / rx - 1.0f;
    buf[1 * ts + p] = 2.0f * (tv - box.lb1) / rt - 1.0f;
  }
}

// a[r] = sum_k in[k][pc + r] W[k][j]: unit j of a dense layer at 4 points.
__device__ __forceinline__ void dense4(const float* in, int ts, const float* __restrict__ W,
                                       int din, int dout, int j, int pc, float (&a)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) a[r] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float w = __ldg(W + k * dout + j);
    const float4 h = ld4(in + k * ts + pc);
    a[0] = fmaf(h.x, w, a[0]);
    a[1] = fmaf(h.y, w, a[1]);
    a[2] = fmaf(h.z, w, a[2]);
    a[3] = fmaf(h.w, w, a[3]);
  }
}

// The hidden layers of a tile whose inputs are in `in`, ping-ponging with
// `out`. Writes each hidden layer's output to `store` ([layer][unit][tile])
// when it is not null. Returns the buffer holding the last hidden output.
__device__ float* hidden_forward(const Net& net, const float* __restrict__ params, float* in,
                                 float* out, int tile, int ts, float* __restrict__ store) {
  const int groups = tile / kR;
  for (int l = 0; l < net.n_layers - 1; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* __restrict__ W = params + net.w_off[l];
    const float* __restrict__ b = params + net.b_off[l];
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      float a[kR];
      dense4(in, ts, W, din, dout, j, pc, a);
      const float bj = b[j];
      float s[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r] = tanhf(a[r] + bj);
      st4(out + j * ts + pc, s);
      if (store != nullptr) {
        st4(store + (static_cast<long long>(l) * net.max_width + j) * tile + pc, s);
      }
    }
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

__global__ void __launch_bounds__(kFwdThreads)
forward_kernel(const float* __restrict__ x, int n, const float* __restrict__ params, Net net,
               Box box, int tile, float* __restrict__ u) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  const int ts = tile + 4;  // row stride, padded against bank conflicts
  float* bufB = bufA + net.max_width * ts;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;
  load_inputs(bufA, ts, x, n, p0, tile, box);
  __syncthreads();
  const float* X = hidden_forward(net, params, bufA, bufB, tile, ts, nullptr);
  const int l = net.n_layers - 1;
  const int din = net.dims[l], dout = net.dims[l + 1];
  const float* __restrict__ W = params + net.w_off[l];
  const float* __restrict__ b = params + net.b_off[l];
  for (int item = threadIdx.x; item < (tile / kR) * dout; item += blockDim.x) {
    const int g = item / dout;
    const int j = item - g * dout;
    const int pc = g * kR;
    float a[kR];
    dense4(X, ts, W, din, dout, j, pc, a);
    const float bj = b[j];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long gp = p0 + pc + r;
      if (gp < n) u[gp * dout + j] = a[r] + bj;
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
backward_kernel(const float* __restrict__ x, int n, const float* __restrict__ params, Net net,
                Box box, int tile, const float* __restrict__ gout, float* __restrict__ partials,
                float* __restrict__ hstore) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = tile, ts = T + 4;
  const int plane = net.max_width * ts;
  float* X = smem;           // the input activations of the current layer
  float* G0 = smem + plane;  // adjoints: this layer's, then the layer below's
  float* Y0 = smem + 2 * plane;
  const int L = net.n_layers;
  const int d_head = net.dims[L];
  float* store = hstore + static_cast<long long>(blockIdx.x) * (L - 1) * net.max_width * T;
  float* part = partials + static_cast<long long>(blockIdx.x) * net.n_params;
  const int n_tiles = (n + T - 1) / T;
  const int groups = T / kR;

  for (int tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const bool first = tix == static_cast<int>(blockIdx.x);
    const long long p0 = static_cast<long long>(tix) * T;
    load_inputs(X, ts, x, n, p0, T, box);
    __syncthreads();
    hidden_forward(net, params, X, Y0, T, ts, store);
    float* G = G0;
    float* Y = Y0;
    for (int e = threadIdx.x; e < d_head * T; e += blockDim.x) {
      const int j = e / T, t = e - j * T;
      G[j * ts + t] = p0 + t < n ? gout[(p0 + t) * d_head + j] : 0.0f;
    }
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      if (l == 0) {
        load_inputs(X, ts, x, n, p0, T, box);
      } else {
        const float* S = store + static_cast<long long>(l - 1) * net.max_width * T;
        for (int e = threadIdx.x; e < din * T; e += blockDim.x) {
          const int k = e / T, t = e - k * T;
          X[k * ts + t] = S[k * T + t];
        }
      }
      __syncthreads();
      const float* __restrict__ W = params + net.w_off[l];
      const int n_w = din * dout + dout;
      const int n_items = n_w + (l > 0 ? din * groups : 0);
      for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        if (item < din * dout) {
          // dW[k][j] = sum_t X[k][t] G[j][t]
          const int k = item / dout, j = item - k * dout;
          float acc = 0.0f;
          for (int t = 0; t < T; t += kR) {
            const float4 xv = ld4(X + k * ts + t);
            const float4 gv = ld4(G + j * ts + t);
            acc = fmaf(xv.x, gv.x, acc);
            acc = fmaf(xv.y, gv.y, acc);
            acc = fmaf(xv.z, gv.z, acc);
            acc = fmaf(xv.w, gv.w, acc);
          }
          const int o = net.w_off[l] + item;
          part[o] = first ? acc : part[o] + acc;
        } else if (item < n_w) {
          // db[j] = sum_t G[j][t]
          const int j = item - din * dout;
          float acc = 0.0f;
          for (int t = 0; t < T; ++t) acc += G[j * ts + t];
          const int o = net.b_off[l] + j;
          part[o] = first ? acc : part[o] + acc;
        } else {
          // the adjoint of layer l-1's pre-activation at 4 points
          const int e = item - n_w;
          const int g = e / din, k = e - g * din;
          const int pc = g * kR;
          float gh[kR] = {0.f, 0.f, 0.f, 0.f};
          for (int j = 0; j < dout; ++j) {
            const float w = __ldg(W + k * dout + j);
            const float4 gv = ld4(G + j * ts + pc);
#pragma unroll
            for (int r = 0; r < kR; ++r) gh[r] = fmaf(get(gv, r), w, gh[r]);
          }
          const float4 xv = ld4(X + k * ts + pc);
          float o[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float s = get(xv, r);
            o[r] = (1.0f - s * s) * gh[r];
          }
          st4(Y + k * ts + pc, o);
        }
      }
      __syncthreads();
      float* tmp = G;
      G = Y;
      Y = tmp;
    }
  }
}

// One thread per parameter: the partial rows summed in block order.
__global__ void reduce_kernel(const float* __restrict__ partials, int rows, int n_params,
                              float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float s = 0.0f;
  for (int b = 0; b < rows; ++b) s += partials[static_cast<long long>(b) * n_params + i];
  grad[i] = s;
}

bool make_net(const int* dims, int n_layers, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[0] != 2) return false;
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

// Dynamic shared memory: `buffers` x max_width rows x (tile + 4) floats
// (ops/kernels/mlp_forward.py::smem_bytes).
size_t smem_bytes(int buffers, int max_width, int tile) {
  return sizeof(float) * static_cast<size_t>(buffers) * static_cast<size_t>(max_width) *
         static_cast<size_t>(tile + 4);
}

}  // namespace

// u = MLP(x) on `stream`. `dims` (host memory) holds n_layers + 1 widths;
// `params` (device) W_0, b_0, W_1, b_1, ... back to back. x is (n, 2), u
// (n, dims[n_layers]), float32, contiguous, on device `device`. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pinns_mlp_forward(const float* x, int n, const float* params, const int* dims,
                                 int n_layers, float lb0, float lb1, float ub0, float ub1,
                                 int tile, int threads, float* u, int device, void* stream) {
  Net net;
  if (n < 0 || !make_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 ||
      threads < 32 || threads > kFwdThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(2, net.max_width, tile);
  err = cudaFuncSetAttribute(forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Box box{lb0, lb1, ub0, ub1};
  const unsigned blocks = static_cast<unsigned>((n + tile - 1) / tile);
  forward_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, params, net, box, tile, u);
  return static_cast<int>(cudaGetLastError());
}

// grad (flat, params order) = d/dparams of sum over points of gout . u, on
// `stream`. gout is (n, dims[n_layers]); `partials` (grid x n_params) and
// `hstore` (grid x (n_layers - 1) x max_width x tile) are scratch. n >= 1.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int pinns_mlp_backward(const float* x, int n, const float* params, const int* dims,
                                  int n_layers, float lb0, float lb1, float ub0, float ub1,
                                  int tile, int grid, const float* gout, float* partials,
                                  float* hstore, float* grad, int device, void* stream) {
  Net net;
  if (n < 1 || !make_net(dims, n_layers, &net) || tile < kR || tile % kR != 0 || grid < 1 ||
      grid > (n + tile - 1) / tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(3, net.max_width, tile);
  err = cudaFuncSetAttribute(backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Box box{lb0, lb1, ub0, ub1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  backward_kernel<<<grid, kBwdThreads, smem, s>>>(x, n, params, net, box, tile, gout, partials,
                                                  hstore);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(partials, grid, net.n_params, grad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
