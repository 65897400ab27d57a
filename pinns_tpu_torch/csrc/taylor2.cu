// Fused Taylor-2 pass of the domain-normalized tanh MLP, for Hopper (sm_90a).
//
// Replaces the TPU kernel `mlp_taylor2_pallas` / `_taylor2_kernel` and its
// lane-packed twin `_taylor2_kernel_packed` (pinns_tpu/ops/pallas/fused_mlp.py
// at git 89afc4b^, lines 148-460). It computes what pinns_tpu/ops/taylor.py::
// mlp_taylor_2 computes for the affine embedding: the value u and the raw-
// coordinate derivatives u_x, u_t, u_xx of every output, in one launch.
//
// Per point, starting from the normalized input h = 2(x - lb)/(ub - lb) - 1
// with tangents hx = (2/(ub0-lb0), 0), ht = (0, 2/(ub1-lb1)) and hxx = 0:
//   P = H W + b,  Px = Hx W,  Pt = Ht W,  Pxx = Hxx W
//   s = tanh P,  Hx = (1 - s^2) Px,  Ht = (1 - s^2) Pt,
//   Hxx = -2 s (1 - s^2) Px^2 + (1 - s^2) Pxx
// through every hidden layer; the head is linear.
//
// Design. One block owns a tile of `tile` points and keeps the four stream
// tiles of the current layer in shared memory, ping-ponged between two
// buffers from layer to layer, so no activation ever goes back to device
// memory. Streams are stored [stream][unit][point] with the point index
// fastest: a thread owns one output unit j and R = 4 consecutive points, reads
// the four streams of its points as one float4 each per k, and does 16 fp32
// FMAs per weight it loads. All four streams of a (point, unit) stay in one
// thread, so the tanh algebra is local. Weights are read row-major straight
// from the packed parameter buffer (L2-resident: 1.1 MB at width 200).
// The kernel masks the ragged last tile itself; the host pads nothing.
//
// What bounds it on the H100: at width 200 the fp32 FMA issue rate (no tensor
// cores: the residual path keeps full fp32, no TF32) and the shared-memory
// loads that feed it (four LDS.128 per 16 FMAs); at width 20 and small N the
// launch and the per-layer __syncthreads latency. Tensor cores (wgmma), TMA
// weight staging and a persistent grid are later work.
//
// K6, the same kernel instantiated with kMixed: the Taylor-2 pass under the
// bf16 stream policy. It replaces the TPU kernel `mlp_taylor2_pallas_mixed` /
// `_taylor2_kernel_mixed` (fused_mlp.py at git 89afc4b^: kernel line 285,
// wrapper 329, pallas_call 373) and computes what pinns_tpu/ops/taylor.py::
// mlp_taylor_2 computes for a mixed spec (compute_dtype bfloat16 on float32
// masters; `_StreamPolicy`, taylor.py:55-88), as the port's plain version
// ops/taylor.py::mlp_taylor_2_reference does:
//   - layer 0 takes the exact float32 coordinates with float32 weights;
//   - a quantized stream (flags qv: value, qd: the x/t derivatives, qxx: xx)
//     is stored in bf16 at every layer boundary, and its dot multiplies the
//     stored values by bf16(W) with float32 accumulation; a kept stream
//     stays float32 with float32 weights;
//   - under `me` (mixed_elementwise) a quantized stream's dot output (the
//     value stream after adding b in float32) is rounded to bf16, and every
//     elementwise op whose result type is bf16 rounds again, in the plain
//     version's operation order (csrc/taylor2_policy.cuh, which the backward
//     shares);
//   - the head is a plain dot (+ b for the value), float32 outputs.
// The TPU kernel's own case (every stream quantized, float32 elementwise) is
// qv = qd = qxx = 1, me = 0. The streams stay float32 values in shared memory
// that hold bf16 values where quantized; the weight is rounded to bf16 in
// registers for the streams that take it. A bf16 x bf16 product is exact in
// float32, so the float32 FMAs accumulate what a bf16 tensor-core product
// with float32 accumulation would (in another order).
//
// What bounds K6 at the main path's shape (8x200, one 8,192-point microbatch
// of burgers_scale): the operations. 4 streams x 2 x 280,600 MACs = 2.245
// MFLOP a point, 18.4 GFLOP a microbatch: 18.6 us at the 989 TFLOP/s bf16
// dense rate when every stream is quantized, 274 us at the 67 TFLOP/s fp32
// rate. K6 does the bf16 products on the fp32 FMA units, so the fp32 rate is
// its own ceiling; it moves 24 bytes a point. Tensor cores (mma.sync or wgmma
// on bf16 tiles with TMA weight staging) are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "taylor2_policy.cuh"

namespace {

constexpr int kMaxLayers = 32;
constexpr int kR = 4;  // points per thread (one float4 per stream)
constexpr int kMaxThreads = 640;  // leaves ptxas 102 registers a thread: no spills

struct Net {
  int n_layers;
  int max_width;                // rows of one stream buffer (widest layer)
  int dims[kMaxLayers + 1];     // layer widths, dims[0] == 2
  long long w_off[kMaxLayers];  // offsets of W_l (din x dout, row-major)
  long long b_off[kMaxLayers];  // offsets of b_l (dout)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[kR]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kMixed>
__global__ void __launch_bounds__(kMaxThreads)
taylor2_kernel(const float* __restrict__ x, int n,
               const float* __restrict__ params, Net net, Policy q,
               float lb0, float lb1, float ub0, float ub1, int tile,
               float* __restrict__ u, float* __restrict__ ux,
               float* __restrict__ ut, float* __restrict__ uxx) {
  extern __shared__ float4 smem4[];
  float* in = reinterpret_cast<float*>(smem4);
  const int ts = tile + 4;              // row stride, padded against bank conflicts
  const int plane = net.max_width * ts;  // one stream of one buffer
  float* out = in + 4 * plane;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;

  // Initial streams, generated from the raw points and four scalars.
  const float rx = ub0 - lb0, rt = ub1 - lb1;
  const float sx = 2.0f / rx, st = 2.0f / rt;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    float xv = 0.0f, tv = 0.0f;
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    in[0 * plane + 0 * ts + p] = 2.0f * (xv - lb0) / rx - 1.0f;
    in[0 * plane + 1 * ts + p] = 2.0f * (tv - lb1) / rt - 1.0f;
    in[1 * plane + 0 * ts + p] = sx;
    in[1 * plane + 1 * ts + p] = 0.0f;
    in[2 * plane + 0 * ts + p] = 0.0f;
    in[2 * plane + 1 * ts + p] = st;
    in[3 * plane + 0 * ts + p] = 0.0f;
    in[3 * plane + 1 * ts + p] = 0.0f;
  }
  __syncthreads();

  const int groups = tile / kR;
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const float* __restrict__ W = params + net.w_off[l];
    const float* __restrict__ b = params + net.b_off[l];
    const bool head = l == net.n_layers - 1;
    const LayerQ lq(q, l);  // K6: layer 0 takes float32 weights and rounds nothing
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      float a[kR] = {0.f, 0.f, 0.f, 0.f}, ax[kR] = {0.f, 0.f, 0.f, 0.f};
      float at[kR] = {0.f, 0.f, 0.f, 0.f}, axx[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const float w = __ldg(W + static_cast<long long>(k) * dout + j);
        float w0 = w, w1 = w, w3 = w;  // the weights of the value, x/t and xx dots
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
      if (head) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const long long gp = p0 + pc + r;
          if (gp < n) {
            const long long o = gp * dout + j;
            u[o] = a[r] + bj;
            ux[o] = ax[r];
            ut[o] = at[r];
            uxx[o] = axx[r];
          }
        }
      } else {
        float s[kR], sxo[kR], sto[kR], sxxo[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if constexpr (kMixed) {
            float t, d1, d2;
            policy_act(rq(__fadd_rn(a[r], bj), lq.tv), rq(ax[r], lq.td), rq(at[r], lq.td),
                       rq(axx[r], lq.txx), lq, q, t, d1, d2, s[r], sxo[r], sto[r], sxxo[r]);
          } else {
            const float t = tanhf(a[r] + bj);
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
    }
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
}

// Dynamic shared memory of one block: two buffers x four streams x
// max_width rows x (tile + 4) floats (ops/kernels/taylor2.py::smem_bytes).
size_t smem_bytes(int max_width, int tile) {
  return sizeof(float) * 2u * 4u * static_cast<size_t>(max_width) *
         static_cast<size_t>(tile + 4);
}

// The launch of either instantiation: `dims` (host memory) holds n_layers + 1
// widths; `params` (device) holds W_0, b_0, W_1, b_1, ... back to back. x is
// (n, 2) float32, the outputs (n, dims[n_layers]) float32, all contiguous on
// device `device`. Returns the CUDA error code of the launch (0 on success).
template <bool kMixed>
int launch(const float* x, int n, const float* params, const int* dims, int n_layers,
           const Policy& q, float lb0, float lb1, float ub0, float ub1, int tile,
           int threads, float* u, float* ux, float* ut, float* uxx, int device,
           void* stream) {
  if (n < 0 || n_layers < 1 || n_layers > kMaxLayers || dims[0] != 2 ||
      tile < kR || tile % kR != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net;
  net.n_layers = n_layers;
  net.max_width = 0;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.dims[l] = dims[l];
    if (dims[l] > net.max_width) net.max_width = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net.w_off[l] = off;
    off += static_cast<long long>(dims[l]) * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(net.max_width, tile);
  err = cudaFuncSetAttribute(taylor2_kernel<kMixed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((n + tile - 1) / tile);
  taylor2_kernel<kMixed><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, params, net, q, lb0, lb1, ub0, ub1, tile, u, ux, ut, uxx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: the fused pass in float32 on `stream` (arguments as `launch`).
extern "C" int pinns_taylor2_forward(const float* x, int n, const float* params,
                                     const int* dims, int n_layers, float lb0,
                                     float lb1, float ub0, float ub1, int tile,
                                     int threads, float* u, float* ux,
                                     float* ut, float* uxx, int device,
                                     void* stream) {
  return launch<false>(x, n, params, dims, n_layers, Policy{false, false, false, false}, lb0,
                       lb1, ub0, ub1, tile, threads, u, ux, ut, uxx, device, stream);
}

// K6: the fused pass under the bf16 stream policy; `params` are the float32
// masters. `policy` packs the flags: 1 value quantized, 2 x/t derivatives
// quantized, 4 xx quantized, 8 mixed_elementwise.
extern "C" int pinns_taylor2_mixed_forward(const float* x, int n, const float* params,
                                           const int* dims, int n_layers, int policy,
                                           float lb0, float lb1, float ub0, float ub1,
                                           int tile, int threads, float* u, float* ux,
                                           float* ut, float* uxx, int device, void* stream) {
  if (policy < 0 || policy > 15) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, n, params, dims, n_layers, decode_policy(policy), lb0, lb1, ub0, ub1,
                      tile, threads, u, ux, ut, uxx, device, stream);
}

extern "C" const char* pinns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
