"""Is the tensor cores' float32 accumulation of bf16 products the exact sum?

K6 under the bf16 stream policy multiplies bf16 streams by bf16 weights with
float32 accumulation, and chip_smoke.py's phase 16 holds it to the plain
mixed version (cuBLAS float32 products of the same bf16 values) within 3e-5
of max|plain|. A bf16 x bf16 product is exact in float32, so two float32 sums
of the same products agree wherever both are exact. This script measures how
often `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` is not: per problem one
warp sums `steps` k16 chunks into a 16 x 8 tile (the accumulator carried
between chunks, as a GEMM does), and each output is compared with the exact
sum (float64 of the same bf16 inputs) rounded once to float32. Inputs are
tanh-like values times init-scale weights, as in the 8x200 net's layers.

    python scripts/hmma_accumulation.py [--problems 2000]

Needs an NVIDIA GPU (sm_90a) and nvcc; builds into build/hmma_accumulation/.
Prints one JSON line per step count, with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "hmma_accumulation")
SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// D (16 x 8) = sum over `steps` chunks of A_s (16 x 16, row-major) B_s (16 x 8,
// row-major (k, n)), one warp a problem, fragments read straight from memory.
__global__ void tc(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D, int steps) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* a = A + (size_t)blockIdx.x * steps * 256;
  const __nv_bfloat16* b = B + (size_t)blockIdx.x * steps * 128;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const __nv_bfloat16* as = a + s * 256;
    const __nv_bfloat16* bs = b + s * 128;
    __nv_bfloat162 f[6] = {{as[g * 16 + 2 * t], as[g * 16 + 2 * t + 1]},
                           {as[(g + 8) * 16 + 2 * t], as[(g + 8) * 16 + 2 * t + 1]},
                           {as[g * 16 + 2 * t + 8], as[g * 16 + 2 * t + 9]},
                           {as[(g + 8) * 16 + 2 * t + 8], as[(g + 8) * 16 + 2 * t + 9]},
                           {bs[(2 * t) * 8 + g], bs[(2 * t + 1) * 8 + g]},
                           {bs[(2 * t + 8) * 8 + g], bs[(2 * t + 9) * 8 + g]}};
    const unsigned* r = reinterpret_cast<const unsigned*>(f);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]));
  }
  float* o = D + (size_t)blockIdx.x * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}
extern "C" int run(const void* A, const void* B, void* D, int problems, int steps) {
  tc<<<problems, 32>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (float*)D, steps);
  return (int)cudaDeviceSynchronize();
}
"""


def build() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "hmma.cu"), os.path.join(OUT, "libhmma.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lib = build()
    gen = torch.Generator().manual_seed(0)
    p = args.problems
    for steps in (1, 13):  # one k16 chunk; the 13 of a 200-wide layer
        a = torch.tanh(3 * torch.randn((p, steps, 16, 16), generator=gen))
        b = 0.1 * torch.randn((p, steps, 16, 8), generator=gen)
        A, B = (t.to(torch.bfloat16).cuda().contiguous() for t in (a, b))
        D = torch.empty((p, 16, 8), device="cuda")
        err = lib.run(A.data_ptr(), B.data_ptr(), D.data_ptr(), p, steps)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        exact = torch.einsum("psmk,pskn->pmn", A.double(), B.double())
        differs = (D != exact.float()).double().mean().item()
        rel = ((D.double() - exact).abs() / exact.abs().max()).max().item()
        print(json.dumps({"steps": steps, "outputs": p * 128,
                          "share_not_float32_of_exact_sum": differs,
                          "max_abs_err_over_max_abs_sum": rel, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
