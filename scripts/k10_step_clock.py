"""Where a step of K10's two-loop spends its cycles, on the card: a copy of
``csrc/lbfgs.cu`` with ``clock64()`` stores inserted at each phase of a
step, built and run once on a seeded full history, for the one-block design
of commit 3a96337 (``--tree DIR``: a tree that holds it, e.g. ``git archive
3a96337 | tar -x -C build/parent``) and for this tree's cluster design.

    python scripts/k10_step_clock.py [--tree build/parent] [--n 3023] [--m 50]
        [--variants base,warp_only,...] [--out FILE]

Thread 0 of CTA 0 stores ``clock64()`` (its SM's cycle counter) at six
points of every step of the two loops: ``issued`` (the step's loads issued),
``dot`` (the thread's
part of the dot product done), ``butterfly`` (the warp's butterfly done),
``exchange`` (one block: past the block barrier; the cluster: past its own
mbarrier's wait, every warp's sum in), ``tree`` (the 32 warp sums reduced)
and ``axpy`` (q updated). Each clock read takes the phase's value as an
operand, so it cannot run before the value exists. The variants:

- The one-block design (``--tree``): ``base``; ``warp_only`` (the block
  barrier and the second butterfly removed: a warp's own sum stands for the
  block's); ``no_loads`` (the history's loads replaced by a constant);
  ``small`` and ``smem_hist`` at ``--small-n`` params (the history read from
  L2, then from a copy in shared memory that only a cut-down n fits).
- This tree's cluster design: ``base`` (the plan's layout: 8 CTAs, the pairs
  resident); ``streamed`` (the second loop reads the
  pairs from global memory again); ``arrive_exchange`` (each sum sent by a remote
  shared store and a remote mbarrier arrival with release at cluster scope,
  where the kernel sends it by st.async); ``test_wait`` (the exchange's wait
  a spin on mbarrier.test_wait, where the kernel blocks in try_wait).

Prints one JSON line a variant: the median cycles of each phase over the
two loops' 2 count steps, the median cycles a step, the step's share of
each phase, the cycles from the state's load to the final store, before the
first step and after the last one, the kernel's device time by CUDA events (a captured graph of 20
launches, each after the copies that restore its input, less the copies
alone) for the instrumented copy and for the library the port builds, and
the card's name and power limit. The sources of the port carry no
instrumentation: the stores exist only in the copies this script makes.
Needs one NVIDIA GPU and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLOCK_SLOTS = 4096
REPS = 20

# the instrumentation, inserted after the source's includes
HEADER = r"""
__device__ long long k10_clk[%(slots)d];
__device__ __forceinline__ int* k10_clk_slot() {
  __shared__ int i;
  return &i;
}
#define K10_CLK_START() do { if (threadIdx.x == 0) *k10_clk_slot() = 0; __syncthreads(); } while (0)
#define K10_CLK(ph, v) do { \
    if (threadIdx.x == 0 && blockIdx.x == 0) { \
      long long c_; \
      asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(c_) : "f"(v) : "memory"); \
      int* ip_ = k10_clk_slot(); \
      const int i_ = *ip_; \
      if (i_ < %(slots)d) k10_clk[i_] = (c_ << 4) | (ph); \
      *ip_ = i_ + 1; \
    } \
  } while (0)
""" % {"slots": CLOCK_SLOTS}

FOOTER = r"""
extern "C" int k10_clock_read(long long* out) {
  if (cudaDeviceSynchronize() != cudaSuccess) return -1;
  return cudaMemcpyFromSymbol(out, k10_clk, sizeof(long long) * %(slots)d) == cudaSuccess ? 0 : -1;
}
extern "C" int k10_clock_clear() {
  static long long zero[%(slots)d];
  return cudaMemcpyToSymbol(k10_clk, zero, sizeof zero) == cudaSuccess ? 0 : -1;
}
""" % {"slots": CLOCK_SLOTS}


# the send half of gather in the "arrive_exchange" variant
ARRIVE_EXCHANGE = r"""  if (lane < ex.ranks) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(
                       map_rank(smem_addr(&sh.red[ex.turn][k][warp]), lane)),
                   "f"(v[k])
                   : "memory");
    }
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                     map_rank(bar, lane))
                 : "memory");
  }
"""


def _sub(src: str, old: str, new: str, count: int) -> str:
    """Replace ``old`` (which must occur ``count`` times) by ``new``."""
    found = src.count(old)
    if found != count:
        raise RuntimeError(f"k10_step_clock: {old[:60]!r} occurs {found} times, not {count}: "
                           "the source is not the design this script instruments")
    return src.replace(old, new)


def _ends(src: str, last: str) -> str:
    """The kernel's start (phase 6, after the state's load) and end (phase
    7, before ``last``, its final state store)."""
    src = _sub(src, "  load_state(sh, si, sf);\n  if (sh.i[kDone] || !sh.i[kNeedDir]) return;\n",
               "  load_state(sh, si, sf);\n  if (sh.i[kDone] || !sh.i[kNeedDir]) return;\n"
               "  K10_CLK_START();\n  K10_CLK(6, 0.0f);\n", 1)
    return _sub(src, f"  {last}\n}}\n\n// Raise, never lower",
                f"  K10_CLK(7, 0.0f);\n  {last}\n}}\n\n// Raise, never lower", 1)


def instrument_parent(src: str, variant: str) -> str:
    """The one-block direction kernel (two_loop_registers, block_sum)."""
    src = _sub(src, "#include <stddef.h>\n", "#include <stddef.h>\n" + HEADER, 1)
    src = _ends(src, "store_state(sh, si, sf);")
    src = _sub(src, """__device__ __forceinline__ float block_sum(float v, Shared& sh, int& turn) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sh.red[turn][threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_sum(sh.red[turn][threadIdx.x & 31]);
  turn ^= 1;
  return v;
}""", """__device__ __forceinline__ float block_sum(float v, Shared& sh, int& turn) {
  K10_CLK(1, v);
  v = warp_sum(v);
  K10_CLK(2, v);
  if ((threadIdx.x & 31) == 0) sh.red[turn][threadIdx.x >> 5] = v;
  __syncthreads();
  K10_CLK(3, 0.0f);
  v = warp_sum(sh.red[turn][threadIdx.x & 31]);
  K10_CLK(4, v);
  turn ^= 1;
  return v;
}""", 1)
    src = _sub(src, "    float p = 0.0f;\n#pragma unroll\n    for (int k = 0; k < kPer; ++k) {\n"
                    "      if (threadIdx.x + k * kThreads < n) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));",
               "    K10_CLK(0, 0.0f);\n    float p = 0.0f;\n#pragma unroll\n"
               "    for (int k = 0; k < kPer; ++k) {\n"
               "      if (threadIdx.x + k * kThreads < n) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));", 2)
    src = _sub(src, "      a[k] = nxt[k];\n    }\n", "      a[k] = nxt[k];\n    }\n"
                                                     "    K10_CLK(5, q[0]);\n", 2)
    if variant == "warp_only":
        src = _sub(src, "  if ((threadIdx.x & 31) == 0) sh.red[turn][threadIdx.x >> 5] = v;\n"
                        "  __syncthreads();\n  K10_CLK(3, 0.0f);\n"
                        "  v = warp_sum(sh.red[turn][threadIdx.x & 31]);\n",
                   "  K10_CLK(3, 0.0f);\n", 1)
    elif variant == "no_loads":
        for name in ("s", "y", "s_next", "y_next"):
            src = _sub(src, f"? {name}[i] : 0.0f", "? 0.5f : 0.0f", src.count(f"? {name}[i] : 0.0f"))
    elif variant == "smem_hist":
        # the pairs copied into shared memory before the two loops: 2 m n
        # floats more a launch
        src = _sub(src, "  float* alpha = dyn;\n",
                   "  float* alpha = dyn;\n  float* hsm = dyn + m;\n"
                   "  for (size_t i = threadIdx.x; i < 2 * static_cast<size_t>(m) * N; i += kThreads) "
                   "hsm[i] = hist[i];\n  __syncthreads();\n", 1)
        src = _sub(src, "two_loop_registers<1>(d, g, hist, rho,", "two_loop_registers<1>(d, g, hsm, rho,",
                   1)
        src = _sub(src, "sizeof(float) * (static_cast<size_t>(m) + (n > kMaxPer * kThreads ? n : 0));",
                   "sizeof(float) * (static_cast<size_t>(m) + 2 * static_cast<size_t>(m) * n);", 1)
    return src + FOOTER


def instrument_cluster(src: str, variant: str) -> str:
    """This tree's cluster design (direction_kernel<kPer, kResident>, gather)."""
    src = _sub(src, "#include <stdint.h>\n", "#include <stdint.h>\n" + HEADER, 1)
    src = _ends(src, "finish(sh, si, sf, ex.rank);\n  cluster_wait();  // the exit's (its arrive came after the last gather)")
    src = _sub(src, """#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = kMax ? warp_max(v[k]) : warp_sum(v[k]);
  Shared& sh = *ex.sh;""", """  K10_CLK(1, v[0]);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = kMax ? warp_max(v[k]) : warp_sum(v[k]);
  K10_CLK(2, v[0]);
  Shared& sh = *ex.sh;""", 1)
    src = _sub(src, "  ex.parity ^= 1u << ex.turn;\n",
               "  K10_CLK(3, 0.0f);\n  ex.parity ^= 1u << ex.turn;\n", 1)
    src = _sub(src, "\n  for (int k = 0; k < K; ++k) v[k] = tree32<kMax>(sh.red[ex.turn][k]);\n",
               "\n  for (int k = 0; k < K; ++k) v[k] = tree32<kMax>(sh.red[ex.turn][k]);\n"
               "  K10_CLK(4, v[0]);\n", 1)
    src = _sub(src, "      float p = 0.0f;\n#pragma unroll\n      for (int k = 0; k < kPer; ++k) {\n"
                    "        if (in_range(k)) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));",
               "      K10_CLK(0, 0.0f);\n      float p = 0.0f;\n#pragma unroll\n"
               "      for (int k = 0; k < kPer; ++k) {\n"
               "        if (in_range(k)) p = __fadd_rn(p, __fmul_rn(a[k], q[k]));", 2)
    src = _sub(src, "        a[k] = nxt[k];\n      }\n",
               "        a[k] = nxt[k];\n      }\n      K10_CLK(5, q[0]);\n", 2)
    if variant == "test_wait":  # the wait as a spin on the non-blocking test
        src = _sub(src, "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;",
                   "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;", 1)
    if variant == "arrive_exchange":
        # the exchange without st.async: every sum a remote shared store,
        # then a remote arrival with release at cluster scope (32 a phase)
        src = _sub(src, '"r"(1 + static_cast<int>(blockDim.x) / 32)', '"r"(kWarps)', 1)
        start = src.index("  uint64_t state;\n  if (threadIdx.x == 0) {\n"
                          "    asm volatile(\"mbarrier.arrive.expect_tx")
        end = src.index("  asm volatile(\n      \"{\\n\\t.reg .pred P1;", start)
        src = src[:start] + ARRIVE_EXCHANGE + src[end:]
    return src + FOOTER


def build(src: str, tmp: str, name: str, clocked: bool = True) -> ctypes.CDLL:
    from pinns_tpu_torch.ops.kernels import build as kbuild

    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(tmp, f"lib{name}.so")
    cmd = [kbuild.nvcc_path(), *kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", out, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(out)
    if clocked:
        lib.k10_clock_read.argtypes = [ctypes.c_void_p]
        lib.k10_clock_clear.argtypes = []
    return lib


def launcher(lib, b, parent: bool, resident: bool):
    """fn(launch_only) launching ``lib``'s direction kernel on ``b``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.pinns_lbfgs_direction
    if parent:
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
    else:
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    ptrs = [t.data_ptr() for t in b.tensors()]

    def launch(launch_only: int = 0):
        stream = torch.cuda.current_stream().cuda_stream
        if parent:
            err = fn(*ptrs, b.n, b.m, launch_only, stream)
        else:
            err = fn(*ptrs, b.n, b.m, int(resident), launch_only, stream)
        if err != 0:
            raise RuntimeError(f"direction launch failed: error {err}")
    return launch


def graph_ms(fn) -> float:
    """Device ms of one ``fn()`` (launch-only work): REPS calls in a captured
    graph, the median of 5 replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def split(raw, steps: int) -> dict:
    """The records' per-step phase cycles: the first ``steps`` runs of
    issued -> dot -> butterfly -> exchange -> tree -> axpy."""
    recs = [(int(r) >> 4, int(r) & 15) for r in raw if r != 0]
    rows, i = [], 0
    while i + 6 < len(recs) and len(rows) < steps:
        phs = [ph for _, ph in recs[i:i + 7]]
        if phs == [0, 1, 2, 3, 4, 5, 0]:
            c = [clk for clk, _ in recs[i:i + 7]]
            rows.append([c[1] - c[0], c[2] - c[1], c[3] - c[2], c[4] - c[3], c[5] - c[4],
                         c[6] - c[5]])
            i += 6
        else:
            i += 1
    if not rows:
        raise RuntimeError(f"k10_step_clock: no complete step in {len(recs)} records")
    start = next(clk for clk, ph in recs if ph == 6)
    end = next(clk for clk, ph in recs if ph == 7)
    first = next(clk for clk, ph in recs if ph == 0)
    last = [clk for clk, ph in recs if ph == 5][-1]
    # the columns: dot, butterfly, exchange, tree, axpy, then the next step's
    # issue (its loads, copies and waits) before its dot
    names = ("dot", "butterfly", "exchange", "tree", "axpy", "issued")
    med = {nm: statistics.median(r[k] for r in rows) for k, nm in enumerate(names)}
    step = statistics.median(sum(r) for r in rows)
    return {"steps_split": len(rows), "cycles": med, "cycles_per_step": step,
            "share": {nm: med[nm] / step for nm in names},
            "cycles_kernel": end - start, "cycles_before_first_step": first - start,
            "cycles_after_last_step": end - last}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="a tree holding the one-block csrc/lbfgs.cu")
    ap.add_argument("--n", type=int, default=3_023)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--small-n", type=int, default=256)
    ap.add_argument("--variants", default="base,warp_only,no_loads,small,smem_hist,"
                                          "streamed,arrive_exchange,test_wait")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k10_step_clock: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.ops.kernels import build as kbuild
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    wanted = args.variants.split(",")
    parent_variants = [v for v in ("base", "warp_only", "no_loads", "small", "smem_hist")
                       if v in wanted] if args.tree else []
    cluster_variants = [v for v in ("base", "streamed", "arrive_exchange", "test_wait")
                        if v in wanted]
    with open(os.path.join(ROOT, "pinns_tpu_torch", "csrc", "lbfgs.cu")) as f:
        ours = f.read()
    theirs = None
    if args.tree:
        with open(os.path.join(args.tree, "pinns_tpu_torch", "csrc", "lbfgs.cu")) as f:
            theirs = f.read()
    # one nvcc a distinct source, all started together
    jobs = {}
    for v in parent_variants:
        jobs[("parent", v)] = instrument_parent(theirs, "base" if v == "small" else v)
    if parent_variants:
        jobs[("parent_library", "")] = theirs
    for v in cluster_variants:
        jobs[("cluster", v)] = instrument_cluster(
            ours, v if v in ("arrive_exchange", "test_wait") else "base")
    sources = {}
    for key, src in jobs.items():
        sources.setdefault(src, []).append(key)
    libs, errors = {}, []
    kbuild.prebuild(["lbfgs"])
    real = kbuild.load_library("lbfgs")
    with tempfile.TemporaryDirectory() as tmp:
        def one(idx, src, keys):
            try:
                lib = build(src, tmp, f"k10clock{idx}", clocked=keys[0][0] != "parent_library")
                for key in keys:
                    libs[key] = lib
            except RuntimeError as e:  # reported after every build ended
                errors.append(e)

        threads = [threading.Thread(target=one, args=(idx, src, keys))
                   for idx, (src, keys) in enumerate(sources.items())]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

        rows = []
        for (design, v), lib in libs.items():
            if design == "parent_library":
                continue
            parent = design == "parent"
            n = args.small_n if v in ("small", "smem_hist") else args.n
            count = args.m
            snap = k_lbfgs.seeded_state(n, args.m, count, 9, seed=21, device="cuda")
            b = snap.clone()
            resident = k_lbfgs.cluster_plan(n, args.m).resident and v != "streamed"
            launch = launcher(lib, b, parent, resident)
            real_launch = (launcher(libs[("parent_library", "")], b, True, False) if parent
                           else launcher(real, b, False, resident))

            def restore():
                for dst, src in zip(b.tensors(), snap.tensors()):
                    dst.copy_(src)

            restore()
            launch()  # sets the kernel up
            restore()
            if lib.k10_clock_clear() != 0:
                raise RuntimeError("k10_clock_clear failed")
            launch()
            raw = (ctypes.c_longlong * CLOCK_SLOTS)()
            if lib.k10_clock_read(ctypes.cast(raw, ctypes.c_void_p)) != 0:
                raise RuntimeError("k10_clock_read failed")
            row = {"design": "one_block" if parent else "cluster", "variant": v, "n": n,
                   "m": args.m, "count": count, "card": card,
                   "ctas": 1 if parent else k_lbfgs.CLUSTER,
                   "resident": None if parent else resident, **split(raw, 2 * count)}
            copies = graph_ms(restore)
            row["ms_instrumented"] = graph_ms(lambda: (restore(), launch(1))) - copies
            if v != "smem_hist":  # the library has no such variant
                restore()
                real_launch()
                row["ms_library"] = graph_ms(lambda: (restore(), real_launch(1))) - copies
            row["us_per_step_instrumented"] = 1e3 * row["ms_instrumented"] / (2 * count)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
