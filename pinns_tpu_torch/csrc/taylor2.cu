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
// K6, the same kernels instantiated with kMixed: the Taylor-2 pass under the
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
// that hold bf16 values where quantized. A bf16 x bf16 product is exact in
// float32, so the float32 FMAs accumulate what a bf16 tensor-core product
// with float32 accumulation would (in another order).
//
// Two designs, one launch a call each, chosen by the widths
// (ops/kernels/taylor2.py::launch_config mirrors the choice):
//
// The tiled design (any width above kNarrowWidth; the 8x200 net of
// burgers_scale, abgrall_l1 and the Euler trunks). Like the TPU kernel, it
// stacks the four streams of a tile into one matrix and takes one product a
// layer. A block owns kTP = 32 points, kRows = 128 stacked rows ordered
// point-major with the stream fastest (row = 4 point + stream), and keeps
// them in shared memory k-major (S[k][row], one buffer: a layer's epilogue
// writes its outputs over its inputs after a barrier, holding them in
// registers meanwhile), so nothing but the four outputs goes back to device
// memory. Per layer the block multiplies S (128 x din) by W_l (din x dout):
// each thread accumulates an 8 x 8 register tile, the rows of points rg and
// rg + 16 (all four streams of each, so p, px, pt, pxx of one (point, unit)
// lie in one thread's registers) by 8 consecutive units. Per k a thread reads
// two float4 of S (a quarter warp reads 128 consecutive bytes) and two of the
// weights (broadcast across the 16 threads of a column group) for 64 FMAs.
// W_l arrives in slices of kKD rows through 16-byte cp.async (4-byte where a
// layer's rows are not 16-byte aligned) into a ring of kStages stages; the
// feed runs across layer boundaries, so the next layer's first slices load
// during this layer's last products and its epilogue. Every output's sum is
// K1's: k ascending, fmaf from zero, b added after. The tanh rule runs in the
// epilogue, in registers. The head (output width 1 on every preset) is a
// reduction over the units: each thread's 8-unit partial sums of its rows,
// then one thread a row sums the partials in column-group order and adds b.
// K6: a quantized stream's rows take bf16(W), which each slice gets once in
// shared memory (rounded one slice ahead of its use, round-to-nearest-even as
// bf16r), so the inner loop rounds nothing; the kernel is instantiated per
// policy word, so which rows take which copy and which of the policy's
// roundings the epilogue does are fixed at compile time.
//
// The narrow design (every width <= kNarrowWidth: the served 8x20 model,
// burgers_forward, abgrall_admm), the per-tile kernel, kept for its
// latency: a thread owns one unit and 4 points, its four streams in a float4
// each per k ([stream][unit][point] in shared memory, ping-ponged between two
// buffers), 16 FMAs per weight read from L2; up to 128 points a block.
//
// K1's float64 mode (pinns_taylor2_forward_f64: `polish`'s residual on the
// card) is the narrow design instantiated on double: the same layout with
// 8-byte values (two double2 loads a stream), __fma_rn and double tanh, at
// most kMaxThreadsF64 threads a block. The H100 runs double at 34 TFLOP/s
// outside the tensor cores, half its fp32 rate; at 8x20 the launch and the
// per-layer barriers still dominate. The tiled design, Fourier features,
// shock paths, the member axis and the mixed policy stay float32.
//
// What bounds it on the H100: at width 200 the operations. A point costs
// 4 streams x 2 x 280,600 MACs = 2.245 MFLOP, so one 8,192-point microbatch
// of burgers_scale takes 274 us at the 67 TFLOP/s fp32 rate (no tensor cores
// or TF32 for the float32 streams, by the numerics rule) and moves 24 bytes a
// point; a quantized stream's products could run at the 989 TFLOP/s bf16
// rate on tensor cores, but K6 keeps them on the fp32 FMA units: mma.sync's
// float32 accumulation of bf16 products is not the float32 sum of the exact
// products (scripts/hmma_accumulation.py), and a pre-activation a few ulps
// off flips the policy's next bf16 rounding away from the plain version's.
// At width 20 and small N, the launch and the per-layer barriers.
//
// Fourier and shock-path features (tiled design only, float32 only;
// csrc/fourier.cuh; pinns_tpu/models/mlp.py:223-340, ops/taylor.py:146,
// :187): with F Fourier features and K paths the first layer's input is
// [x^, t^, sin z_1..F, cos z_1..F, phi_1..K], 2 + 2F + K wide, and the
// block generates all four streams of each of its points' rows in S
// (write_input_rows, a thread a point) from B (by value) and from path_c and
// path_a (after the trunk in the flat params, at the same offset in every
// member's row). Layer 0 then takes whole slices like any other layer, and S
// and the slice pitch cover the wider input. The narrow design and K6 refuse
// them (a net with features takes the tiled design at any width).
//
// K8s (a), the member axis (pinns_taylor2_forward_members): E nets of one
// shape in one launch, member m as blockIdx.y, its weights at m P of one
// (E, P) buffer and its streams at m N C of each (E, N, C) output. It
// replaces the vmap of JAX's ensemble prediction over the stacked members
// (pinns_tpu/parallel/ensemble.py:340, pinns_tpu/serve.py:126). Each member's
// blocks run a solo call's arithmetic, so its streams equal a solo call's bit
// for bit; the work is E times a solo call's, bounded as above.

#include <cuda_runtime.h>
#include <stddef.h>

#include "fourier.cuh"
#include "taylor2_policy.cuh"

namespace {

constexpr int kMaxLayers = 32;

struct Net {
  int n_layers;
  int max_width;                // rows of a stream buffer: the widest layer (narrow), input (tiled)
  int dims[kMaxLayers + 1];     // layer widths, dims[0] == 2 + 2F + K
  long long w_off[kMaxLayers];  // offsets of W_l (din x dout, row-major)
  long long b_off[kMaxLayers];  // offsets of b_l (dout)
  unsigned vec_mask;            // tiled: bit l, W_l's rows are 16-byte aligned (16-byte copies)
  long long n_params;           // the trunk's parameters (the paths' follow them)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// The narrow design: the per-tile kernel.

constexpr int kNarrowWidth = 32;
constexpr int kR = 4;  // points per thread (one float4 per stream)
constexpr int kMaxThreads = 640;  // leaves ptxas 102 registers a thread: no spills
constexpr int kMaxThreadsF64 = 256;  // the float64 mode's bound: double streams, no spills

// Four consecutive values of a stream: one float4, or two double2 in the
// float64 mode (rows of tile + 4 values keep both 16-byte aligned).
template <typename R>
__device__ __forceinline__ void ld4(const R* p, R (&v)[kR]) {
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

// R float: K1 (K6 with kMixed); R double: K1's float64 mode (polish), the
// same arithmetic in double (fused multiply-adds __fma_rn, double tanh), the
// streams' buffers twice as wide, at most kMaxThreadsF64 threads a block.
template <typename R, bool kMixed>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kMaxThreads : kMaxThreadsF64)
narrow_kernel(const R* __restrict__ x, int n,
              const R* __restrict__ params, Net net, Policy q,
              R lb0, R lb1, R ub0, R ub1, int tile,
              R* __restrict__ u, R* __restrict__ ux,
              R* __restrict__ ut, R* __restrict__ uxx,
              long long param_stride, long long out_stride) {
  static_assert(sizeof(R) == 4 || !kMixed, "the stream policy is float32's");
  // member blockIdx.y: its weights at m param_stride, its streams at m out_stride
  params += blockIdx.y * param_stride;
  u += blockIdx.y * out_stride;
  ux += blockIdx.y * out_stride;
  ut += blockIdx.y * out_stride;
  uxx += blockIdx.y * out_stride;
  extern __shared__ float4 smem4[];
  R* in = reinterpret_cast<R*>(smem4);
  const int ts = tile + 4;              // row stride, padded against bank conflicts
  const int plane = net.max_width * ts;  // one stream of one buffer
  R* out = in + 4 * plane;
  const long long p0 = static_cast<long long>(blockIdx.x) * tile;

  // Initial streams, generated from the raw points and four scalars.
  const R rx = ub0 - lb0, rt = ub1 - lb1;
  const R sx = R(2) / rx, st = R(2) / rt;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    R xv = R(0), tv = R(0);
    if (p0 + p < n) {
      xv = x[2 * (p0 + p)];
      tv = x[2 * (p0 + p) + 1];
    }
    in[0 * plane + 0 * ts + p] = R(2) * (xv - lb0) / rx - R(1);
    in[0 * plane + 1 * ts + p] = R(2) * (tv - lb1) / rt - R(1);
    in[1 * plane + 0 * ts + p] = sx;
    in[1 * plane + 1 * ts + p] = R(0);
    in[2 * plane + 0 * ts + p] = R(0);
    in[2 * plane + 1 * ts + p] = st;
    in[3 * plane + 0 * ts + p] = R(0);
    in[3 * plane + 1 * ts + p] = R(0);
  }
  __syncthreads();

  const int groups = tile / kR;
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const R* __restrict__ W = params + net.w_off[l];
    const R* __restrict__ b = params + net.b_off[l];
    const bool head = l == net.n_layers - 1;
    const LayerQ lq(q, l);  // K6: layer 0 takes float32 weights and rounds nothing
    for (int item = threadIdx.x; item < groups * dout; item += blockDim.x) {
      const int g = item / dout;
      const int j = item - g * dout;
      const int pc = g * kR;
      R a[kR] = {R(0), R(0), R(0), R(0)}, ax[kR] = {R(0), R(0), R(0), R(0)};
      R at[kR] = {R(0), R(0), R(0), R(0)}, axx[kR] = {R(0), R(0), R(0), R(0)};
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const R w = __ldg(W + static_cast<long long>(k) * dout + j);
        R w0 = w, w1 = w, w3 = w;  // the weights of the value, x/t and xx dots
        if constexpr (kMixed) {
          const float wb = bf16r(w);
          w0 = lq.wv ? wb : w;
          w1 = lq.wd ? wb : w;
          w3 = lq.wxx ? wb : w;
        }
        R h[kR], hx[kR], ht[kR], hxx[kR];
        ld4(in + 0 * plane + k * ts + pc, h);
        ld4(in + 1 * plane + k * ts + pc, hx);
        ld4(in + 2 * plane + k * ts + pc, ht);
        ld4(in + 3 * plane + k * ts + pc, hxx);
#pragma unroll
        for (int r = 0; r < kR; ++r) a[r] = fma_of(h[r], w0, a[r]);
#pragma unroll
        for (int r = 0; r < kR; ++r) ax[r] = fma_of(hx[r], w1, ax[r]);
#pragma unroll
        for (int r = 0; r < kR; ++r) at[r] = fma_of(ht[r], w1, at[r]);
#pragma unroll
        for (int r = 0; r < kR; ++r) axx[r] = fma_of(hxx[r], w3, axx[r]);
      }
      const R bj = b[j];
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
        R s[kR], sxo[kR], sto[kR], sxxo[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if constexpr (kMixed) {
            float t, d1, d2;
            policy_act(rq(__fadd_rn(a[r], bj), lq.tv), rq(ax[r], lq.td), rq(at[r], lq.td),
                       rq(axx[r], lq.txx), lq, q, t, d1, d2, s[r], sxo[r], sto[r], sxxo[r]);
          } else if constexpr (sizeof(R) == 4) {
            const float t = tanhf(a[r] + bj);
            const float d1 = 1.0f - t * t;
            const float d2 = -2.0f * t * d1;
            s[r] = t;
            sxo[r] = d1 * ax[r];
            sto[r] = d1 * at[r];
            sxxo[r] = d2 * ax[r] * ax[r] + d1 * axx[r];
          } else {  // the float64 mode: the plain recurrence's operations in double
            const double t = tanh_of(a[r] + bj);
            const double d1 = 1.0 - t * t;
            const double d2 = -2.0 * t * d1;
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
    R* tmp = in;
    in = out;
    out = tmp;
  }
}

// Dynamic shared memory of a narrow block: two buffers x four streams x
// max_width rows x (tile + 4) values of `item` bytes (4, or 8 in the
// float64 mode).
size_t narrow_smem_bytes(int max_width, int tile, size_t item = sizeof(float)) {
  return item * 2u * 4u * static_cast<size_t>(max_width) * static_cast<size_t>(tile + 4);
}

// ---------------------------------------------------------------------------
// The tiled design.

constexpr int kTP = 32;           // points a block
constexpr int kRows = 4 * kTP;    // stacked rows: row = 4 point + stream
constexpr int kKD = 16;           // rows of W in a slice
constexpr int kStages = 3;        // slices in the ring
constexpr int kTiledMaxThreads = 512;  // 16 row groups x 32 column groups (width 256)
constexpr int kMinThreads = kRows;     // the head's last step takes a thread a row

// 4 or 16 bytes, of which the first `bytes` are read and the rest zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

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

// The weight feed: the next slice to load (layer l, rows k0 .. k0 + kKD - 1
// of W_l, columns 0 .. dout - 1; the rows past din are filled with zeros),
// walking the hidden layers' slices in order and on over the layer
// boundaries. Every call commits one group, empty once the hidden layers are
// done, so that the consumer's wait counts stay fixed.
struct Feed {
  int l, k0;

  __device__ void issue(const Net& net, const float* __restrict__ params, float* slot, int mp,
                        int n_hidden) {
    if (l < n_hidden) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      const int kc = min(kKD, din - k0);
      const float* __restrict__ W = params + net.w_off[l] + static_cast<long long>(k0) * dout;
      if ((net.vec_mask >> l) & 1u) {
        const int q = dout / 4;
        for (int i = threadIdx.x; i < kKD * q; i += blockDim.x) {
          const int kk = i / q, c = 4 * (i - kk * q);
          const bool ok = kk < kc;
          cp_async16(slot + kk * mp + c, ok ? W + kk * dout + c : W, ok ? 16 : 0);
        }
      } else {
        for (int i = threadIdx.x; i < kKD * dout; i += blockDim.x) {
          const int kk = i / dout, c = i - kk * dout;
          const bool ok = kk < kc;
          cp_async4(slot + kk * mp + c, ok ? W + kk * dout + c : W, ok ? 4 : 0);
        }
      }
      k0 += kKD;
      if (k0 >= din) {
        ++l;
        k0 = 0;
      }
    }
    cp_async_commit();
  }
};

// One slice's FMAs into a thread's 8 x 8 tile. Rows 0-3 of the tile are the
// streams (value, x, t, xx) of point rg, rows 4-7 those of point rg + 16.
// kQ says which streams' rows take the bf16-rounded weights Wb (bit 0 the
// value, bit 1 the x/t derivatives, bit 2 xx); the others take Wf.
template <int kQ, bool kPartial>
__device__ __forceinline__ void fma_slice(const float* __restrict__ S,
                                          const float* __restrict__ Wf,
                                          const float* __restrict__ Wb, int k0, int kc, int mp,
                                          int rA, int c0, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
    if (!kPartial || kk < kc) {
      const float* srow = S + (k0 + kk) * kRows;
      const float4 a0 = ld4(srow + rA), a1 = ld4(srow + rA + kRows / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float wf[8], wb[8];
      if (kQ != 7) {
        const float4 v0 = ld4(Wf + kk * mp + c0), v1 = ld4(Wf + kk * mp + c0 + 4);
        wf[0] = v0.x; wf[1] = v0.y; wf[2] = v0.z; wf[3] = v0.w;
        wf[4] = v1.x; wf[5] = v1.y; wf[6] = v1.z; wf[7] = v1.w;
      }
      if (kQ != 0) {
        const float4 v0 = ld4(Wb + kk * mp + c0), v1 = ld4(Wb + kk * mp + c0 + 4);
        wb[0] = v0.x; wb[1] = v0.y; wb[2] = v0.z; wb[3] = v0.w;
        wb[4] = v1.x; wb[5] = v1.y; wb[6] = v1.z; wb[7] = v1.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int s = r & 3;
        const bool qr = ((kQ >> (s == 0 ? 0 : (s == 3 ? 2 : 1))) & 1) != 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], qr ? wb[c] : wf[c], acc[r][c]);
      }
    }
  }
}

// The epilogue of a hidden layer: from the thread's tile of pre-activations,
// its outputs (the tanh rule under the policy word kPol; kFirst: layer 0,
// whose dots round nothing) over its inputs in S. The policy is known at
// compile time, so no rounding that it leaves out costs an instruction.
template <bool kMixed, int kPol, bool kFirst>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8], const float* __restrict__ b,
                                         float* S, int rA, int c0, int dout) {
  const Policy pol{(kPol & 1) != 0, (kPol & 2) != 0, (kPol & 4) != 0, (kPol & 8) != 0};
  const LayerQ lq(pol, kFirst ? 0 : 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int j = c0 + c;
    if (j >= dout) break;
    const float bj = __ldg(b + j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = acc[4 * h][c], px = acc[4 * h + 1][c], pt = acc[4 * h + 2][c],
                  pxx = acc[4 * h + 3][c];
      float o0, o1, o2, o3;
      if constexpr (kMixed) {
        float t, d1, d2;
        policy_act(rq(__fadd_rn(p, bj), lq.tv), rq(px, lq.td), rq(pt, lq.td), rq(pxx, lq.txx),
                   lq, pol, t, d1, d2, o0, o1, o2, o3);
      } else {
        const float t = tanhf(p + bj);
        const float d1 = 1.0f - t * t;
        const float d2 = -2.0f * t * d1;
        o0 = t;
        o1 = d1 * px;
        o2 = d1 * pt;
        o3 = d2 * px * px + d1 * pxx;
      }
      *reinterpret_cast<float4*>(S + j * kRows + rA + h * (kRows / 2)) =
          make_float4(o0, o1, o2, o3);
    }
  }
}

// kPol: K1 when negative, else K6 under that policy word (decode_policy).
template <int kPol>
__global__ void __launch_bounds__(kTiledMaxThreads, 1)
tiled_kernel(const float* __restrict__ x, int n, const float* __restrict__ params, Net net,
             Fourier fo, int n_paths, int path_degree, float lb0, float lb1, float ub0,
             float ub1, int mp, float* __restrict__ u, float* __restrict__ ux,
             float* __restrict__ ut, float* __restrict__ uxx, long long param_stride,
             long long out_stride) {
  constexpr bool kMixed = kPol >= 0;
  // member blockIdx.y, as in the narrow design
  params += blockIdx.y * param_stride;
  u += blockIdx.y * out_stride;
  ux += blockIdx.y * out_stride;
  ut += blockIdx.y * out_stride;
  uxx += blockIdx.y * out_stride;
  constexpr int kCode = kMixed ? kPol & 7 : 0;  // the rows of layers > 0 that take bf16(W)
  const Policy q{kMixed && (kPol & 1) != 0, kMixed && (kPol & 2) != 0,
                 kMixed && (kPol & 4) != 0, kMixed && (kPol & 8) != 0};
  // shared memory: S (max_width x kRows), the ring (kStages x kKD x mp),
  // K6's rounded slices (2 x kKD x mp)
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* ring = S + net.max_width * kRows;
  float* wq = ring + kStages * kKD * mp;
  const int tid = threadIdx.x;
  const int rg = tid % 16, cg = tid / 16;
  const int rA = 4 * rg, c0 = 8 * cg;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTP;
  const int n_hidden = net.n_layers - 1;

  Feed feed{0, 0};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) feed.issue(net, params, ring + i * kKD * mp, mp, n_hidden);

  // Initial streams, generated from the raw points, four scalars and the
  // features' parameters: a thread a point writes its four rows (row 4 p +
  // stream, column c at S[c kRows + row]).
  const float rx = ub0 - lb0, rt = ub1 - lb1;
  const float sx = 2.0f / rx, st = 2.0f / rt;
  const float* pc = params + net.n_params;
  const Paths paths{n_paths, path_degree, pc, pc + n_paths * (path_degree + 1)};
  for (int p = tid; p < kTP; p += blockDim.x) {
    const long long gp = p0 + p;
    float xv = 0.0f, tv = 0.0f;
    if (gp < n) {
      xv = x[2 * gp];
      tv = x[2 * gp + 1];
    }
    const float xn = 2.0f * (xv - lb0) / rx - 1.0f, tn = 2.0f * (tv - lb1) / rt - 1.0f;
    float* row = S + 4 * p;
    write_input_rows(fo, paths, xn, tn, sx, st, net.dims[0], kRows, row, row + 1, row + 2,
                     row + 3);
  }

  auto round_slice = [&](int g) {  // K6: bf16(W) of slice g, once, into its slot
    const float4* src = reinterpret_cast<const float4*>(ring + (g % kStages) * kKD * mp);
    float4* dst = reinterpret_cast<float4*>(wq + (g & 1) * kKD * mp);
    for (int i = tid; i < kKD * mp / 4; i += blockDim.x) {
      const float4 v = src[i];
      dst[i] = make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
    }
  };
  if constexpr (kMixed) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    round_slice(0);
  }

  int g = 0;  // the slice being consumed, counted over all layers
  for (int l = 0; l < n_hidden; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const bool active = c0 < dout;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    }
    for (int k0 = 0; k0 < din; k0 += kKD, ++g) {
      // slice g has landed (K6: and g + 1, which is rounded now, one step
      // ahead of its products); every thread is done with slice g - 1, whose
      // ring slot takes slice g + kStages - 1 and whose bf16 slot takes g + 1
      cp_async_wait<kMixed ? kStages - 3 : kStages - 2>();
      __syncthreads();
      feed.issue(net, params, ring + ((g + kStages - 1) % kStages) * kKD * mp, mp, n_hidden);
      if constexpr (kMixed) round_slice(g + 1);
      if (!active) continue;
      const float* wf = ring + (g % kStages) * kKD * mp;
      const float* wb = wq + (g & 1) * kKD * mp;
      const int kc = min(kKD, din - k0);
      if (l == 0) {  // float32 weights: din = 2 (one partial slice) or the features' width
        if (kc == kKD) {
          fma_slice<0, false>(S, wf, wb, k0, kc, mp, rA, c0, acc);
        } else {
          fma_slice<0, true>(S, wf, wb, k0, kc, mp, rA, c0, acc);
        }
      } else if (kc == kKD) {
        fma_slice<kCode, false>(S, wf, wb, k0, kc, mp, rA, c0, acc);
      } else {
        fma_slice<kCode, true>(S, wf, wb, k0, kc, mp, rA, c0, acc);
      }
    }
    __syncthreads();  // every read of this layer's inputs is done: S takes its outputs
    if (!active) continue;
    const float* __restrict__ b = params + net.b_off[l];
    if (l == 0) {
      epilogue<kMixed, kPol, true>(acc, b, S, rA, c0, dout);
    } else {
      epilogue<kMixed, kPol, false>(acc, b, S, rA, c0, dout);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last layer's outputs are in S; the ring is free

  // The head, a reduction over its input units: each thread sums its rows'
  // products over its 8 units (k ascending, fmaf from zero) into P (the ring's
  // space), then a thread a row adds the column groups' partials in order,
  // and b on value rows.
  const int hl = net.n_layers - 1;
  const int din = net.dims[hl], out = net.dims[hl + 1];
  const float* __restrict__ W = params + net.w_off[hl];
  const float* __restrict__ b = params + net.b_off[hl];
  const LayerQ lq(q, hl);
  const int groups = (din + 7) / 8;
  float* P = ring;
  for (int o = 0; o < out; ++o) {
    if (c0 < din) {
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int k1 = min(c0 + 8, din);
      for (int k = c0; k < k1; ++k) {
        const float4 a0 = ld4(S + k * kRows + rA), a1 = ld4(S + k * kRows + rA + kRows / 2);
        const float w = __ldg(W + static_cast<long long>(k) * out + o);
        float w0 = w, w1 = w, w3 = w;
        if constexpr (kMixed) {
          const float wb = bf16r(w);
          w0 = lq.wv ? wb : w;
          w1 = lq.wd ? wb : w;
          w3 = lq.wxx ? wb : w;
        }
        part[0] = fmaf(a0.x, w0, part[0]);
        part[1] = fmaf(a0.y, w1, part[1]);
        part[2] = fmaf(a0.z, w1, part[2]);
        part[3] = fmaf(a0.w, w3, part[3]);
        part[4] = fmaf(a1.x, w0, part[4]);
        part[5] = fmaf(a1.y, w1, part[5]);
        part[6] = fmaf(a1.z, w1, part[6]);
        part[7] = fmaf(a1.w, w3, part[7]);
      }
      *reinterpret_cast<float4*>(P + cg * kRows + rA) =
          make_float4(part[0], part[1], part[2], part[3]);
      *reinterpret_cast<float4*>(P + cg * kRows + rA + kRows / 2) =
          make_float4(part[4], part[5], part[6], part[7]);
    }
    __syncthreads();
    for (int r = tid; r < kRows; r += blockDim.x) {
      float sum = P[r];
      for (int c = 1; c < groups; ++c) sum += P[c * kRows + r];
      const int s = r & 3;
      if (s == 0) sum += __ldg(b + o);
      const long long gp = p0 + r / 4;
      if (gp < n) {
        float* dst = s == 0 ? u : (s == 1 ? ux : (s == 2 ? ut : uxx));
        dst[gp * out + o] = sum;
      }
    }
    __syncthreads();
  }
}

int policy_word(const Policy& q) {
  return (q.qv ? 1 : 0) | (q.qd ? 2 : 0) | (q.qxx ? 4 : 0) | (q.me ? 8 : 0);
}

// The tiled design's weight-slice pitch: the widest layer input, rounded up
// to whole 8-unit column groups.
int tiled_pitch(int max_width) { return (max_width + 7) / 8 * 8; }

// Dynamic shared memory of a tiled block (ops/kernels/taylor2.py::launch_config).
size_t tiled_smem_bytes(int max_width, bool mixed) {
  const int mp = tiled_pitch(max_width);
  return sizeof(float) * (static_cast<size_t>(max_width) * kRows +
                          static_cast<size_t>((kStages + (mixed ? 2 : 0)) * kKD * mp));
}

int tiled_threads(int max_width) {
  const int t = 16 * ((max_width + 7) / 8);
  return t < kMinThreads ? kMinThreads : t;
}

// The launch of either instantiation: `dims` (host memory) holds n_layers + 1
// widths; `params` (device) holds W_0, b_0, W_1, b_1, ... back to back. x is
// (n, 2) float32, the outputs (n, dims[n_layers]) float32, all contiguous on
// device `device`. A net whose widths are all <= kNarrowWidth takes the
// narrow design with `tile` points and `threads` threads a block; any other
// the tiled design, which takes tile == kTP and threads == tiled_threads of
// its widest layer input. Anything else is refused. Returns the CUDA error
// code of the launch (0 on success).
//
// `members` nets of these widths in one launch (K8s's member axis, the grid's
// y): member m's params start at m param_stride floats (param_stride >= the
// net's parameter count) and its four outputs at m n dims[n_layers] floats of
// each output buffer. The tile plan does not depend on `members`, and member
// m's blocks run exactly the arithmetic of a one-member call on its weights,
// so every member's streams equal a solo call's bit for bit.
//
// With Fourier features or paths (`fo`, n_paths > 0; float32 only) dims[0] is
// 2 + 2 fo.f + n_paths, the net takes the tiled design whatever its widths,
// and a member's path_c and path_a follow its trunk.
template <bool kMixed>
int launch(const float* x, int n, const float* params, int members, long long param_stride,
           const int* dims, int n_layers, const Fourier& fo, int n_paths, int path_degree,
           const Policy& q, float lb0, float lb1, float ub0, float ub1, int tile, int threads,
           float* u, float* ux, float* ut, float* uxx, int device, void* stream) {
  const bool embed = fo.f > 0 || n_paths > 0;
  if (n < 0 || n_layers < 1 || n_layers > kMaxLayers || members < 1 || members > 65535 ||
      !fourier_ok(fo.f) || !paths_ok(n_paths, path_degree) || (kMixed && embed) ||
      dims[0] != 2 + 2 * fo.f + n_paths) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net;
  net.n_layers = n_layers;
  int widest = 0, widest_in = 0;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
    if (l < n_layers && dims[l] > widest_in) widest_in = dims[l];
  }
  net.vec_mask = 0;
  const bool aligned = (reinterpret_cast<size_t>(params) & 15) == 0;
  for (int l = 0; l < n_layers; ++l) {
    net.w_off[l] = off;
    if (aligned && off % 4 == 0 && dims[l + 1] % 4 == 0) net.vec_mask |= 1u << l;
    off += static_cast<long long>(dims[l]) * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
  }
  net.n_params = off;
  const long long path_params = static_cast<long long>(n_paths) * (path_degree + 2);
  if (members > 1) {
    if (param_stride < off + path_params) return static_cast<int>(cudaErrorInvalidValue);
    if (param_stride % 4 != 0) net.vec_mask = 0;  // a later member's rows lose 16-byte alignment
  }
  const long long out_stride = static_cast<long long>(n) * dims[n_layers];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool narrow = widest <= kNarrowWidth && !embed;
  if (narrow) {
    if (tile < kR || tile % kR != 0 || threads < 32 || threads > kMaxThreads ||
        threads % 32 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    net.max_width = widest;
    const size_t smem = narrow_smem_bytes(widest, tile);
    err = cudaFuncSetAttribute(narrow_kernel<float, kMixed>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return static_cast<int>(cudaSuccess);
    const dim3 blocks(static_cast<unsigned>((n + tile - 1) / tile), static_cast<unsigned>(members));
    narrow_kernel<float, kMixed><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, n, params, net, q, lb0, lb1, ub0, ub1, tile, u, ux, ut, uxx, param_stride, out_stride);
    return static_cast<int>(cudaGetLastError());
  }
  net.max_width = widest_in;
  if (tile != kTP) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 blocks(static_cast<unsigned>((n + kTP - 1) / kTP), static_cast<unsigned>(members));
  if (threads != tiled_threads(widest_in) || threads > kTiledMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mp = tiled_pitch(widest_in);
  const size_t smem = tiled_smem_bytes(widest_in, kMixed);
  auto go = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess || n == 0) return static_cast<int>(e);
    kernel<<<blocks, threads, smem, st>>>(x, n, params, net, fo, n_paths, path_degree, lb0, lb1,
                                          ub0, ub1, mp, u, ux, ut, uxx, param_stride,
                                          out_stride);
    return static_cast<int>(cudaGetLastError());
  };
  if (!kMixed) return go(tiled_kernel<-1>);
  // the policy words a mixed spec has (ops/kernels/taylor2.py::policy_flags:
  // the x/t derivatives are always quantized)
  switch (policy_word(q)) {
    case 2: return go(tiled_kernel<2>);
    case 3: return go(tiled_kernel<3>);
    case 6: return go(tiled_kernel<6>);
    case 7: return go(tiled_kernel<7>);
    case 10: return go(tiled_kernel<10>);
    case 11: return go(tiled_kernel<11>);
    case 14: return go(tiled_kernel<14>);
    case 15: return go(tiled_kernel<15>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1's float64 mode: the narrow design on double points, params and streams
// (`polish` on the card). Every width <= kNarrowWidth, no features, no
// member axis; `tile` a multiple of kR and `threads` a multiple of 32 up to
// kMaxThreadsF64 (ops/kernels/taylor2.py::launch_config(..., float64)).
int launch_f64(const double* x, int n, const double* params, const int* dims, int n_layers,
               double lb0, double lb1, double ub0, double ub1, int tile, int threads, double* u,
               double* ux, double* ut, double* uxx, int device, void* stream) {
  if (n < 0 || n_layers < 1 || n_layers > kMaxLayers || dims[0] != 2 || tile < kR ||
      tile % kR != 0 || threads < 32 || threads > kMaxThreadsF64 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Net net;
  net.n_layers = n_layers;
  net.vec_mask = 0;
  int widest = 0;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kNarrowWidth) return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t smem = narrow_smem_bytes(widest, tile, sizeof(double));
  err = cudaFuncSetAttribute(narrow_kernel<double, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 blocks(static_cast<unsigned>((n + tile - 1) / tile), 1u);
  narrow_kernel<double, false><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, params, net, Policy{false, false, false, false}, lb0, lb1, ub0, ub1, tile, u, ux, ut,
      uxx, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1's float64 mode on `stream` (arguments as launch_f64): x (n, 2), params
// and the four outputs (n, dims[n_layers]) float64, contiguous, on device
// `device`.
extern "C" int pinns_taylor2_forward_f64(const double* x, int n, const double* params,
                                         const int* dims, int n_layers, double lb0, double lb1,
                                         double ub0, double ub1, int tile, int threads,
                                         double* u, double* ux, double* ut, double* uxx,
                                         int device, void* stream) {
  return launch_f64(x, n, params, dims, n_layers, lb0, lb1, ub0, ub1, tile, threads, u, ux, ut,
                    uxx, device, stream);
}

// K1: the fused pass in float32 on `stream` (arguments as `launch`);
// `fourier` (host memory) holds the n_fourier frequencies 2 pi B[:, 0], then
// the n_fourier 2 pi B[:, 1] (null when n_fourier is 0).
extern "C" int pinns_taylor2_forward(const float* x, int n, const float* params,
                                     const int* dims, int n_layers, int n_fourier,
                                     const float* fourier, int n_paths, int path_degree,
                                     float lb0, float lb1, float ub0, float ub1, int tile,
                                     int threads, float* u, float* ux,
                                     float* ut, float* uxx, int device,
                                     void* stream) {
  if (!fourier_ok(n_fourier)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, n, params, 1, 0, dims, n_layers, make_fourier(n_fourier, fourier),
                       n_paths, path_degree, Policy{false, false, false, false}, lb0, lb1, ub0,
                       ub1, tile, threads, u, ux, ut, uxx, device, stream);
}

// K8s (a): K1 for `members` nets of one shape in one launch; member m's
// params at params + m param_stride, its streams at m n dims[n_layers] floats
// into each output buffer (E, n, out); the rest as `launch`.
extern "C" int pinns_taylor2_forward_members(const float* x, int n, const float* params,
                                             int members, long long param_stride,
                                             const int* dims, int n_layers, int n_fourier,
                                             const float* fourier, int n_paths,
                                             int path_degree, float lb0,
                                             float lb1, float ub0, float ub1, int tile,
                                             int threads, float* u, float* ux, float* ut,
                                             float* uxx, int device, void* stream) {
  if (!fourier_ok(n_fourier)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, n, params, members, param_stride, dims, n_layers,
                       make_fourier(n_fourier, fourier), n_paths, path_degree,
                       Policy{false, false, false, false}, lb0, lb1, ub0, ub1, tile, threads, u,
                       ux, ut, uxx, device, stream);
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
  return launch<true>(x, n, params, 1, 0, dims, n_layers, make_fourier(0, nullptr), 0, 0,
                      decode_policy(policy), lb0, lb1, ub0, ub1, tile, threads, u, ux, ut, uxx,
                      device, stream);
}

extern "C" const char* pinns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
