"""Time the wide design of K5 (``csrc/mlp_forward.cu``) on the card with each
of its two block tiles, forward and backward, to place the plan's switch
from the small tile to the large one
(``ops/kernels/mlp_forward.py::LARGE_TILE_MIN_BLOCKS``).

    python scripts/k5_tile_sweep.py [--layers 2,200,200,200,200,200,200,200,200,1]
        [--n 100,2000,8192,16384,32768,65536] [--reps 20] [--profile] [--tree DIR]

Prints the card's name and power limit, then one JSON line per (N, tile):
CUDA-event medians of ``--reps`` calls after warm-up (host work included),
the plan, and how far the two tiles' outputs lie apart. ``--profile`` adds
each call's device time, summed over its kernels by torch.profiler, and its
kernel count. ``--tree DIR`` times the K5 of another checkout (an older
commit unpacked with ``git archive``) with its own design only. Random
weights from a seed. Needs one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, calls: int = 20):
    """(device microseconds, kernels, {kernel: microseconds}) per call of
    ``fn``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel, count = {}, 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = t / calls
            count += evt.count
    return sum(by_kernel.values()), count / calls, by_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="2," + "200," * 8 + "1")
    ap.add_argument("--n", default="100,2000,8192,16384,32768,65536")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("k5_tile_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    layers = tuple(int(w) for w in args.layers.split(","))
    lb, ub = (-1.0, 0.0), (1.0, 0.99)
    spec = MLPSpec(layers=layers, lb=lb, ub=ub)
    params = init_mlp(spec, torch.Generator().manual_seed(200), "cuda")
    switch = getattr(k_mlp, "LARGE_TILE_MIN_BLOCKS", None)
    tiles = (("small", 1 << 30), ("large", 0)) if switch is not None and not args.tree else \
        (("own", switch),)
    for n in (int(v) for v in args.n.split(",")):
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.uniform(lb, ub, size=(n, 2)).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32) / n).cuda()
        outs = {}
        for tile, min_blocks in tiles:
            if switch is not None:
                k_mlp.LARGE_TILE_MIN_BLOCKS = min_blocks
            try:
                forward = lambda: k_mlp.mlp_forward(spec, params, x)  # noqa: E731
                backward = lambda: k_mlp.mlp_backward(spec, params, x, g)  # noqa: E731
                row = {"n": n, "tile": tile, "forward_ms": event_ms(forward, args.reps),
                       "backward_ms": event_ms(backward, args.reps)}
                if args.profile:
                    for name, fn in (("forward", forward), ("backward", backward)):
                        (row[f"{name}_device_us"], row[f"{name}_kernels"],
                         row[f"{name}_us_by_kernel"]) = device_us(fn)
                outs[tile] = (forward(), backward())
                if switch is not None:
                    row["backward_plan"] = dataclasses.asdict(k_mlp.mlp_backward_plan(layers, n))
            finally:
                if switch is not None:
                    k_mlp.LARGE_TILE_MIN_BLOCKS = switch
            print(json.dumps({**row, "layers": list(layers), "tree": args.tree or ".",
                              "card": card, "clock": "cuda_events", "reps": args.reps}),
                  flush=True)
        if len(outs) < 2:
            continue
        (u_s, g_s), (u_l, g_l) = outs["small"], outs["large"]
        print(json.dumps({"n": n, "tiles_agree": {
            "u_max_abs_diff": float((u_s - u_l).abs().max()),
            "u_max_abs": float(u_s.abs().max()),
            "grad_max_abs_diff": float((g_s - g_l).abs().max()),
            "grad_max_abs": float(g_s.abs().max())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
