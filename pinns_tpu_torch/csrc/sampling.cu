// K11, the generic step's collocation draw, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX draws each epoch's batch with threefry inside
// its scanned step (pinns_tpu/train/trainer.py:360, jax.random.uniform), an
// XLA fusion. The port draws with counter-based Philox-4x32-10 instead
// (data/sampling.py::philox_uniform, whose torch int64 version took about 250
// launches an epoch), and K11 computes exactly its points: point i of the
// draw takes the first two words of Philox(counter (i, epoch low, epoch
// high, 0), key (seed low, seed high)), keeps their top 24 bits,
// u = bits * 2^-24, and maps x = lb + (ub - lb) u in the output type,
// rounding after each operation (__fsub_rn, __fmul_rn, __fadd_rn; no FMA).
//
// It reads the draw's epoch and seed words and its (lb, ub) from row
// *cursor of the epoch schedule (train/schedule.py: ROW_WORDS int32 words a
// row, the words first, then float64 values), so that one launch captured
// in a CUDA graph draws a new batch in every replay. The bounds are float64
// in the row; a float32 draw rounds them to nearest, as torch's
// tensor(lb, dtype=float32) does.
//
// What bounds it on the H100: nothing but its launch. It writes 8 n bytes
// (float32; 16 n float64) and reads one 72-byte row; at the presets' 1,000
// points that is 2.4 ns at 3.35 TB/s, at burgers_scale's 1,048,576 points
// 2.5 us. Philox's ten rounds are some 60 integer operations a point. Design:
// one thread a point, a block of 256, the row's few words read by every
// thread from L1; one 8-byte (float32) or 16-byte (float64) store a point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {
namespace k11 {

constexpr int kThreads = 256;

struct Layout {
  int row_words, epoch_word, seed_word, value_word;  // train/schedule.py
};

__device__ __forceinline__ float affine(float lb, float ub, float u) {
  return __fadd_rn(lb, __fmul_rn(__fsub_rn(ub, lb), u));
}

__device__ __forceinline__ double affine(double lb, double ub, double u) {
  return __dadd_rn(lb, __dmul_rn(__dsub_rn(ub, lb), u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const unsigned* __restrict__ sched, const long long* __restrict__ cursor,
                Layout lay, int n, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned* row = sched + *cursor * lay.row_words;
  const double* v = reinterpret_cast<const double*>(row + lay.value_word);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<unsigned>(i), row[lay.epoch_word], row[lay.epoch_word + 1], 0u),
      make_uint2(row[lay.seed_word], row[lay.seed_word + 1]));
  const T u0 = static_cast<T>(r.x >> 8) * static_cast<T>(5.9604644775390625e-08);
  const T u1 = static_cast<T>(r.y >> 8) * static_cast<T>(5.9604644775390625e-08);
  out[2 * i] = affine(static_cast<T>(v[0]), static_cast<T>(v[2]), u0);
  out[2 * i + 1] = affine(static_cast<T>(v[1]), static_cast<T>(v[3]), u1);
}

}  // namespace k11
}  // namespace

// (n, 2) points into `out` (float32 when `dtype` is 0, float64 when 1) from
// row *cursor of `sched`, on `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pinns_philox_draw(const void* sched, const long long* cursor, int row_words,
                                 int epoch_word, int seed_word, int value_word, int n,
                                 int dtype, void* out, int device, void* stream) {
  if (n < 0 || row_words < 1 || value_word % 2 != 0 || row_words % 2 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const k11::Layout lay{row_words, epoch_word, seed_word, value_word};
  const unsigned blocks = static_cast<unsigned>((n + k11::kThreads - 1) / k11::kThreads);
  const unsigned* s = static_cast<const unsigned*>(sched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    k11::draw_kernel<float><<<blocks, k11::kThreads, 0, st>>>(s, cursor, lay, n,
                                                               static_cast<float*>(out));
  } else {
    k11::draw_kernel<double><<<blocks, k11::kThreads, 0, st>>>(s, cursor, lay, n,
                                                                static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pinns_sampling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
