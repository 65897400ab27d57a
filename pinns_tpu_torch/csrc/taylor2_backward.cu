// Backward of the fused Taylor-2 pass (K1, csrc/taylor2.cu), for Hopper
// (sm_90a): the cotangents of the four streams (u, u_x, u_t, u_xx) -> dW, db
// of every layer.
//
// The TPU package had no kernel for it: its custom-VJP op recomputed the
// Taylor pass in XLA and took the VJP there (pinns_tpu/ops/pallas/
// fused_mlp.py at git 89afc4b^, lines 391-418). The port needs it on the card
// to differentiate the residual of the training loss outside the fused Adam
// step (the L-BFGS phase and the generic Adam step). The algorithm is the
// reverse mode the fused step writes out (header of csrc/fused_step.cu): for
// a hidden layer with s = tanh p, s' = 1 - s^2, s'' = -2 s s' and output
// adjoints (gh, ghx, ght, ghxx):
//   gpxx = ghxx s'              gpx = ghx s' + 2 ghxx s'' px
//   gpt  = ght s'               gp  = s' (gh - 2 s (ghx px + ght pt + ghxx pxx)
//                                         + (6 s^2 - 2) ghxx px^2)
// dW = sum over points and streams of H_in^T gP, db = sum of gp, and the
// input adjoints are gP W^T. Here the head is seeded with the given stream
// cotangents instead of the step's loss. ops/kernels/taylor2.py::
// taylor2_backward_reference is this algorithm in plain PyTorch, held against
// torch.autograd through the plain recurrence by the CPU tests.
//
// Launches, on the caller's stream:
//   1 backward_kernel  block b walks the tiles b, b + grid, ... For each tile:
//                      the Taylor-2 forward through the hidden layers,
//                      keeping the pre-activation streams P (4 per unit) of
//                      every layer in a per-block global scratch (L2-resident:
//                      458 KB a block at 8x20), then the backward layer by
//                      layer in shared memory. The block adds its tiles, in
//                      tile order, into its own row of partial gradients.
//                      dW is computed in 4 x 4 register tiles (8 shared-memory
//                      loads feed 64 FMAs), each entry summed in the same
//                      order as one entry a thread.
//   2 reduce_kernel    one thread per parameter sums the rows in block order.
// No atomics: two calls agree bit for bit. The forward values themselves come
// from K1; this kernel recomputes what it needs rather than have K1 write a
// scratch on every call.
//
// The same kernels, instantiated with kMixed, are the backward of K6 (csrc/
// taylor2.cu under the bf16 stream policy): the forward is recomputed with
// K6's rounding (policy_act, the same code as K6's), the stored streams are
// the bf16-rounded ones, each stream's input adjoint gH = gP W^T takes the
// weights its forward dot used (bf16(W) for a quantized stream), and the tanh
// factors s, s', s'' are the forward's rounded ones. The casts count as
// identity and every cotangent stays float32. This differs from
// torch.autograd through the plain mixed recurrence, which rounds the
// cotangents of bf16 tensors to bf16. JAX's op for the TPU kernel
// (fused_mlp.py:391-418) took the VJP of its XLA recompute, which rounds as
// autograd does.
//
// What bounds it on the H100: at 8x20 and N_f = 1,000 to 10,456 (the training
// residual), latency: 16 to 164 blocks, each a chain of about 26
// barrier-separated layer phases. At 8x200 the operations: 3 x 2.245 MFLOP a
// point (forward recompute, dW, gH), 55 GFLOP for one 8,192-point microbatch
// of burgers_scale, 823 us at 67 TFLOP/s fp32. For K6 the recompute of its
// quantized streams could run at the 989 TFLOP/s bf16 rate, while dW and gH
// take float32 cotangents: 568 us. At 8x200 a block of 512 threads holds 192
// KB of shared memory, one block an SM; the grid x n_params partial rows (1.3
// MB a row) cost about a tenth of the time. wgmma and a persistent grid are
// later work, as for K3.

#include <cuda_runtime.h>
#include <stddef.h>

#include "taylor2_policy.cuh"

namespace {

constexpr int kMaxLayers = 32;
constexpr int kR = 4;          // points per thread item (one float4 per stream)
constexpr int kThreads = 512;  // block size of the backward kernel (one block an SM)

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

struct Seeds {
  const float* g[4];  // cotangents of u, u_x, u_t, u_xx, each (n, dims[n_layers])
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

// Input streams of the tile's points: normalized (x, t) and the constant
// tangents (2/(ub0-lb0), 0), (0, 2/(ub1-lb1)); the second-derivative stream
// is zero. Slots past n hold the streams of the point (0, 0).
__device__ __forceinline__ void input_streams(float* buf, int plane, int ts,
                                              const float* __restrict__ x, int n, long long p0,
                                              int tile, const Box& box) {
  const float rx = box.ub0 - box.lb0, rt = box.ub1 - box.lb1;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    buf[0 * plane + 0 * ts + p] = 2.0f * (xv - box.lb0) / rx - 1.0f;
    buf[0 * plane + 1 * ts + p] = 2.0f * (tv - box.lb1) / rt - 1.0f;
    buf[1 * plane + 0 * ts + p] = 2.0f / rx;
    buf[1 * plane + 1 * ts + p] = 0.0f;
    buf[2 * plane + 0 * ts + p] = 0.0f;
    buf[2 * plane + 1 * ts + p] = 2.0f / rt;
    buf[3 * plane + 0 * ts + p] = 0.0f;
    buf[3 * plane + 1 * ts + p] = 0.0f;
  }
}

// Taylor-2 forward through the hidden layers of a tile whose input streams
// are in `in`, storing each layer's pre-activation streams (after K6's
// rounding under kMixed) in `pstore` ([layer][stream][unit][tile]). Returns
// the buffer that holds the last hidden layer's output streams.
template <bool kMixed>
__device__ float* hidden_forward(const Net& net, const float* __restrict__ params, float* in,
                                 float* out, int tile, int ts, int plane,
                                 float* __restrict__ pstore, const Policy& q) {
  const int groups = tile / kR;
  const long long sstride = static_cast<long long>(net.max_width) * tile;
  for (int l = 0; l < net.n_layers - 1; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* __restrict__ W = params + net.w_off[l];
    const float* __restrict__ b = params + net.b_off[l];
    const LayerQ lq(q, l);
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      float a[kR] = {0.f, 0.f, 0.f, 0.f}, ax[kR] = {0.f, 0.f, 0.f, 0.f};
      float at[kR] = {0.f, 0.f, 0.f, 0.f}, axx[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const float w = __ldg(W + k * dout + j);
        float w0 = w, w1 = w, w3 = w;
        if constexpr (kMixed) {
          const float wb = bf16r(w);
          w0 = lq.wv ? wb : w;
          w1 = lq.wd ? wb : w;
          w3 = lq.wxx ? wb : w;
        }
        const float4 h = ld4(in + 0 * plane + k * ts + pc);
        const float4 hx = ld4(in + 1 * plane + k * ts + pc);
        const float4 ht = ld4(in + 2 * plane + k * ts + pc);
        const float4 hxx = ld4(in + 3 * plane + k * ts + pc);
        a[0] = fmaf(h.x, w0, a[0]);     a[1] = fmaf(h.y, w0, a[1]);
        a[2] = fmaf(h.z, w0, a[2]);     a[3] = fmaf(h.w, w0, a[3]);
        ax[0] = fmaf(hx.x, w1, ax[0]);  ax[1] = fmaf(hx.y, w1, ax[1]);
        ax[2] = fmaf(hx.z, w1, ax[2]);  ax[3] = fmaf(hx.w, w1, ax[3]);
        at[0] = fmaf(ht.x, w1, at[0]);  at[1] = fmaf(ht.y, w1, at[1]);
        at[2] = fmaf(ht.z, w1, at[2]);  at[3] = fmaf(ht.w, w1, at[3]);
        axx[0] = fmaf(hxx.x, w3, axx[0]);  axx[1] = fmaf(hxx.y, w3, axx[1]);
        axx[2] = fmaf(hxx.z, w3, axx[2]);  axx[3] = fmaf(hxx.w, w3, axx[3]);
      }
      const float bj = b[j];
      if constexpr (kMixed) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          a[r] = rq(__fadd_rn(a[r], bj), lq.tv);
          ax[r] = rq(ax[r], lq.td);
          at[r] = rq(at[r], lq.td);
          axx[r] = rq(axx[r], lq.txx);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r) a[r] += bj;
      }
      float* P = pstore + (static_cast<long long>(l) * 4 * net.max_width + j) * tile + pc;
      st4(P + 0 * sstride, a);
      st4(P + 1 * sstride, ax);
      st4(P + 2 * sstride, at);
      st4(P + 3 * sstride, axx);
      float s[kR], sxo[kR], sto[kR], sxxo[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if constexpr (kMixed) {
          float t, d1, d2;
          policy_act(a[r], ax[r], at[r], axx[r], lq, q, t, d1, d2, s[r], sxo[r], sto[r],
                     sxxo[r]);
        } else {
          const float t = tanhf(a[r]);
          const float d1 = 1.0f - t * t;
          const float d2 = -2.0f * t * d1;
          s[r] = t;
          sxo[r] = d1 * ax[r];
          sto[r] = d1 * at[r];
          sxxo[r] = d2 * ax[r] * ax[r] + d1 * axx[r];
        }
      }
      st4(out + 0 * plane + j * ts + pc, s);
      st4(out + 1 * plane + j * ts + pc, sxo);
      st4(out + 2 * plane + j * ts + pc, sto);
      st4(out + 3 * plane + j * ts + pc, sxxo);
    }
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

template <bool kMixed>
__global__ void __launch_bounds__(kThreads)
backward_kernel(const float* __restrict__ x, int n, const float* __restrict__ params, Net net,
                Box box, int tile, Seeds seeds, float* __restrict__ partials,
                float* __restrict__ pstore_all, Policy q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = tile, ts = T + 4;
  const int plane = net.max_width * ts;
  float* bufA = smem;
  float* bufB = smem + 4 * plane;
  float* bufG = smem + 8 * plane;
  const int L = net.n_layers;
  const int d_head = net.dims[L];
  const long long sstride = static_cast<long long>(net.max_width) * T;
  float* pstore = pstore_all + static_cast<long long>(blockIdx.x) * (L - 1) * 4 * sstride;
  float* part = partials + static_cast<long long>(blockIdx.x) * net.n_params;
  const int n_tiles = (n + T - 1) / T;
  const int groups = T / kR;

  for (int tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const bool first = tix == static_cast<int>(blockIdx.x);
    const long long p0 = static_cast<long long>(tix) * T;
    input_streams(bufA, plane, ts, x, n, p0, T, box);
    __syncthreads();
    float* X = hidden_forward<kMixed>(net, params, bufA, bufB, T, ts, plane, pstore, q);
    float* Y = X == bufA ? bufB : bufA;
    float* G = bufG;
    // the head's adjoints: the given cotangents, zero past n
    for (int e = threadIdx.x; e < d_head * T; e += blockDim.x) {
      const int j = e / T, t = e - j * T;
      const bool in = p0 + t < n;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        G[s * plane + j * ts + t] = in ? seeds.g[s][(p0 + t) * d_head + j] : 0.0f;
      }
    }
    __syncthreads();

    // Backward, head first. X holds the layer's input streams, G the adjoints
    // of its pre-activation streams; Y receives those of the layer below.
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      if (l < L - 1) {
        // recompute the input streams of layer l
        if (l == 0) {
          input_streams(X, plane, ts, x, n, p0, T, box);
        } else {
          const float* P = pstore + static_cast<long long>(l - 1) * 4 * sstride;
          const LayerQ lq(q, l - 1);
          for (int e = threadIdx.x; e < din * T; e += blockDim.x) {
            const int k = e / T, t = e - k * T;
            const float p = P[k * T + t], px = P[sstride + k * T + t];
            const float pt = P[2 * sstride + k * T + t], pxx = P[3 * sstride + k * T + t];
            if constexpr (kMixed) {
              float s, d1, d2;
              policy_act(p, px, pt, pxx, lq, q, s, d1, d2,
                         X[0 * plane + k * ts + t], X[1 * plane + k * ts + t],
                         X[2 * plane + k * ts + t], X[3 * plane + k * ts + t]);
            } else {
              const float s = tanhf(p), d1 = 1.0f - s * s, d2 = -2.0f * s * d1;
              X[0 * plane + k * ts + t] = s;
              X[1 * plane + k * ts + t] = d1 * px;
              X[2 * plane + k * ts + t] = d1 * pt;
              X[3 * plane + k * ts + t] = d2 * px * px + d1 * pxx;
            }
          }
        }
        __syncthreads();
      }
      const float* __restrict__ W = params + net.w_off[l];
      // dW in 4 x 4 register tiles: unit j = jq + J4 jj of four strided rows
      // of G (consecutive across a warp: no bank conflicts, coalesced
      // partial rows) and k = 4 kb + kk of four consecutive rows of X (one
      // address across most of a warp: a broadcast)
      const int J4 = (dout + 3) / 4, K4 = (din + 3) / 4;
      const int n_dw = J4 * K4;
      const int n_wgrad = n_dw + dout;
      const int n_items = n_wgrad + (l > 0 ? din * groups : 0);
      const float* Pb = l > 0 ? pstore + static_cast<long long>(l - 1) * 4 * sstride : nullptr;
      const LayerQ lq(q, l), lq_below(q, l > 0 ? l - 1 : 0);
      for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        if (item < n_dw) {
          // dW[k][j] = sum_t sum_s X[s][k][t] G[s][j][t], summed in the same
          // order (points outer, streams inner) for every (k, j). Rows past
          // din / dout read a valid row and are not stored.
          const int jq = item % J4, kb = item / J4;
          int kr[4], jr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kr[i] = min(4 * kb + i, din - 1);
            jr[i] = min(jq + i * J4, dout - 1);
          }
          float acc[4][4] = {};
          for (int t = 0; t < T; t += kR) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              float4 xv[4], gv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                xv[i] = ld4(X + s * plane + kr[i] * ts + t);
                gv[i] = ld4(G + s * plane + jr[i] * ts + t);
              }
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  float a = acc[kk][jj];
                  a = fmaf(xv[kk].x, gv[jj].x, a);
                  a = fmaf(xv[kk].y, gv[jj].y, a);
                  a = fmaf(xv[kk].z, gv[jj].z, a);
                  acc[kk][jj] = fmaf(xv[kk].w, gv[jj].w, a);
                }
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int k = 4 * kb + kk, j = jq + jj * J4;
              if (k < din && j < dout) {
                const int o = net.w_off[l] + k * dout + j;
                part[o] = first ? acc[kk][jj] : part[o] + acc[kk][jj];
              }
            }
          }
        } else if (item < n_wgrad) {
          // db[j] = sum_t G[0][j][t]
          const int j = item - n_dw;
          float acc = 0.0f;
          for (int t = 0; t < T; ++t) acc += G[j * ts + t];
          const int o = net.b_off[l] + j;
          part[o] = first ? acc : part[o] + acc;
        } else {
          // adjoints of layer l's inputs (gH = gP W^T), then through the tanh
          // of layer l-1 to that layer's pre-activations
          const int e = item - n_wgrad;
          const int g = e / din, k = e - g * din;
          const int pc = g * kR;
          float gh[kR] = {0.f, 0.f, 0.f, 0.f}, ghx[kR] = {0.f, 0.f, 0.f, 0.f};
          float ght[kR] = {0.f, 0.f, 0.f, 0.f}, ghxx[kR] = {0.f, 0.f, 0.f, 0.f};
          for (int j = 0; j < dout; ++j) {
            const float w = __ldg(W + k * dout + j);
            float w0 = w, w1 = w, w3 = w;  // the weights each stream's forward dot used
            if constexpr (kMixed) {
              const float wb = bf16r(w);
              w0 = lq.wv ? wb : w;
              w1 = lq.wd ? wb : w;
              w3 = lq.wxx ? wb : w;
            }
            const float4 g0 = ld4(G + 0 * plane + j * ts + pc);
            const float4 g1 = ld4(G + 1 * plane + j * ts + pc);
            const float4 g2 = ld4(G + 2 * plane + j * ts + pc);
            const float4 g3 = ld4(G + 3 * plane + j * ts + pc);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              gh[r] = fmaf(get(g0, r), w0, gh[r]);
              ghx[r] = fmaf(get(g1, r), w1, ghx[r]);
              ght[r] = fmaf(get(g2, r), w1, ght[r]);
              ghxx[r] = fmaf(get(g3, r), w3, ghxx[r]);
            }
          }
          const float4 p = ld4(Pb + k * T + pc);
          const float4 px = ld4(Pb + sstride + k * T + pc);
          const float4 pt = ld4(Pb + 2 * sstride + k * T + pc);
          const float4 pxx = ld4(Pb + 3 * sstride + k * T + pc);
          float o0[kR], o1[kR], o2[kR], o3[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float pr = get(p, r), pxr = get(px, r), ptr = get(pt, r), pxxr = get(pxx, r);
            float s, d1, d2;
            if constexpr (kMixed) {
              float h, hx, ht, hxx;  // unused: the tanh factors are what is needed
              policy_act(pr, pxr, ptr, pxxr, lq_below, q, s, d1, d2, h, hx, ht, hxx);
            } else {
              s = tanhf(pr);
              d1 = 1.0f - s * s;
              d2 = -2.0f * s * d1;
            }
            o3[r] = ghxx[r] * d1;
            o1[r] = ghx[r] * d1 + 2.0f * ghxx[r] * d2 * pxr;
            o2[r] = ght[r] * d1;
            o0[r] = d1 * (gh[r] - 2.0f * s * (ghx[r] * pxr + ght[r] * ptr + ghxx[r] * pxxr) +
                          (6.0f * s * s - 2.0f) * ghxx[r] * pxr * pxr);
          }
          st4(Y + 0 * plane + k * ts + pc, o0);
          st4(Y + 1 * plane + k * ts + pc, o1);
          st4(Y + 2 * plane + k * ts + pc, o2);
          st4(Y + 3 * plane + k * ts + pc, o3);
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

// Dynamic shared memory: three buffers (input streams, two adjoint buffers)
// x four streams x max_width rows x (tile + 4) floats
// (ops/kernels/taylor2.py::backward_smem_bytes).
size_t smem_bytes(int max_width, int tile) {
  return sizeof(float) * 12u * static_cast<size_t>(max_width) * static_cast<size_t>(tile + 4);
}

// grad (flat, params order) = d/dparams of sum over points of
// gu . u + gux . u_x + gut . u_t + guxx . u_xx, on `stream`. `dims` (host)
// holds n_layers + 1 widths; x is (n, 2), each cotangent (n, dims[n_layers]),
// all float32, contiguous, on device `device`. `partials` (grid x n_params)
// and `pstore` (grid x (n_layers - 1) x 4 x max_width x tile) are scratch.
// Returns the CUDA error code of the launches (0 on success).
template <bool kMixed>
int launch(const float* x, int n, const float* params, const int* dims, int n_layers,
           const Policy& q, float lb0, float lb1, float ub0, float ub1, int tile, int grid,
           const float* gu, const float* gux, const float* gut, const float* guxx,
           float* partials, float* pstore, float* grad, int device, void* stream) {
  if (n < 1 || n_layers < 1 || n_layers > kMaxLayers || dims[0] != 2 || tile < kR ||
      tile % kR != 0 || grid < 1 || grid > (n + tile - 1) / tile) {
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(net.max_width, tile);
  err = cudaFuncSetAttribute(backward_kernel<kMixed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Box box{lb0, lb1, ub0, ub1};
  const Seeds seeds{{gu, gux, gut, guxx}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  backward_kernel<kMixed><<<grid, kThreads, smem, s>>>(x, n, params, net, box, tile, seeds,
                                                       partials, pstore, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(net.n_params + 255) / 256, 256, 0, s>>>(partials, grid, net.n_params, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: the backward of K1 (float32 streams).
extern "C" int pinns_taylor2_backward(const float* x, int n, const float* params,
                                      const int* dims, int n_layers, float lb0, float lb1,
                                      float ub0, float ub1, int tile, int grid, const float* gu,
                                      const float* gux, const float* gut, const float* guxx,
                                      float* partials, float* pstore, float* grad, int device,
                                      void* stream) {
  return launch<false>(x, n, params, dims, n_layers, Policy{false, false, false, false}, lb0,
                       lb1, ub0, ub1, tile, grid, gu, gux, gut, guxx, partials, pstore, grad,
                       device, stream);
}

// The backward of K6. `policy` packs K6's flags: 1 value quantized, 2 x/t
// derivatives quantized, 4 xx quantized, 8 mixed_elementwise.
extern "C" int pinns_taylor2_mixed_backward(const float* x, int n, const float* params,
                                            const int* dims, int n_layers, int policy,
                                            float lb0, float lb1, float ub0, float ub1,
                                            int tile, int grid, const float* gu,
                                            const float* gux, const float* gut,
                                            const float* guxx, float* partials, float* pstore,
                                            float* grad, int device, void* stream) {
  if (policy < 0 || policy > 15) return static_cast<int>(cudaErrorInvalidValue);
  const Policy q = decode_policy(policy);
  return launch<true>(x, n, params, dims, n_layers, q, lb0, lb1, ub0, ub1, tile, grid, gu, gux,
                      gut, guxx, partials, pstore, grad, device, stream);
}

extern "C" const char* pinns_taylor2_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
