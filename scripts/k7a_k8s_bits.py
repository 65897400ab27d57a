"""Hold one tree's K7a (``csrc/taylor1.cu``) and K8s (c) (``csrc/ensemble.cu``)
against another's on the card, bit for bit, and time them.

    python scripts/k7a_k8s_bits.py [--tree DIR] --save FILE [--times] [--profile] [--host]
    python scripts/k7a_k8s_bits.py --compare FILE_A FILE_B

``--save`` runs, on random weights and inputs from seeds, K7a's forward (the
design its widths pick) and backward on the Euler trunk 2x200x5x3 at N
1,000, 8,192 and 65,536, on 2x20x3x3 at the same N, on 8x20 (out 1) at
16,000 and 25,600, and on the trunk with two shock paths at 1,000 and
16,000; and K8s (c) at E 3 and 8 on 47,100 points x 6 fields + 3 dx fields;
and writes every output to an ``.npz``. ``--times`` also prints, per shape,
the CUDA-event median of 20 calls after warm-up (one host call each, host
work included) of the forward and backward, and K8s (c) beside
``torch.std_mean`` over the members (mean and std, no dx), the two in turns
over 200 rounds. ``--profile``
adds each call's device time by torch.profiler (5 calls after warm-up):
the sum over its kernels, their count and the largest by name. ``--host``
prints the host's microseconds a call (a loop of 2,000 calls, host clock) of
K8s (c) beside ``torch.std_mean`` and of K7a's forward at 8x20 x 16,000
points and its wrapper's parts (packing the params, checking them), each
design, and with a member's row of packed params. ``--tree DIR``
runs the package of another checkout (an older commit unpacked with ``git
archive``): run both trees in turns in one call. ``--compare`` prints, per
output, whether the two files hold equal arrays (``np.array_equal``) and
the largest difference. Needs one NVIDIA GPU (not ``--compare``); imports
no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

EULER = (2,) + (200,) * 5 + (3,)
EULER_NARROW = (2, 20, 20, 20, 3)
NARROW = (2,) + (20,) * 8 + (1,)
LB, UB = (-1.0, 0.0), (1.0, 0.99)
SHAPES = [(EULER, 0, n) for n in (1_000, 8_192, 65_536)] + \
    [(EULER_NARROW, 0, n) for n in (1_000, 8_192, 65_536)] + \
    [(NARROW, 0, n) for n in (16_000, 25_600)] + [(EULER, 2, n) for n in (1_000, 16_000)]
REDUCE = [(e, 47_100, 6, 3) for e in (3, 8)]
REPS = 20


def event_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def event_ms_turns(torch, fns, reps: int) -> list:
    """The medians of ``fns`` by CUDA events, timed in turns (one call of
    each, ``reps`` rounds)."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def device_us(torch, fn, calls: int = 5) -> dict:
    """Device time a call of ``fn``, summed over its kernels by
    torch.profiler, the kernels a call and the six largest by name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            prev = kernels.get(evt.key, (0.0, 0.0))
            kernels[evt.key] = (prev[0] + us / calls, prev[1] + evt.count / calls)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return {"device_us": sum(v[0] for v in kernels.values()),
            "kernels": sum(v[1] for v in kernels.values()),
            "top": {k[:120]: round(v[0], 2) for k, v in top}}


def host_us(torch, fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn`` in a loop (the card runs behind)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def host_row(torch, k_ens, k_taylor1) -> dict:
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels.taylor2 import check_call, pack_params

    vals = torch.randn(8, 47_100, 6, device="cuda")
    dx = torch.randn(8, 47_100, 3, device="cuda")
    spec = MLPSpec(layers=NARROW, lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(172), "cuda")
    x = torch.rand(16_000, 2, device="cuda")
    outs = [torch.empty(16_000, 1, device="cuda") for _ in range(3)]
    row = {"k8s_reduce": host_us(torch, lambda: k_ens.member_stats(vals, dx)),
           "std_mean": host_us(torch, lambda: torch.std_mean(vals, dim=0, correction=0)),
           "k7a_pack_params": host_us(torch, lambda: pack_params(params)),
           "k7a_check_call": host_us(torch, lambda: check_call("taylor1", spec, params, x,
                                                                  *outs)),
           "k7a_forward": host_us(torch, lambda: k_taylor1.taylor1(spec, params, x), 500)}
    if hasattr(k_taylor1, "default_design"):
        flat = pack_params(params)
        row["k7a_forward_wide"] = host_us(
            torch, lambda: k_taylor1.taylor1(spec, params, x, design="wide"), 500)
        row["k7a_forward_member_row"] = host_us(
            torch, lambda: k_taylor1.taylor1(spec, params, x, out=outs, flat=flat), 500)
    return row


def card_line(torch) -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "not measured"
    return f"{torch.cuda.get_device_name(0)} | {smi}"


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7a_k8s_bits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1

    card = card_line(torch)
    print(card, flush=True)
    if args.host:
        print(json.dumps({"what": "host_us_a_call", "card": card, "tree": args.tree or ".",
                          **host_row(torch, k_ens, k_taylor1)}), flush=True)
    saved = {}
    for layers, paths, n in SHAPES:
        kw = dict(n_paths=paths, path_degree=2, path_sharpness=12.0) if paths else {}
        spec = MLPSpec(layers=layers, lb=LB, ub=UB, **kw)
        params = init_mlp(spec, torch.Generator().manual_seed(170), "cuda")
        gen = torch.Generator().manual_seed(171)
        for p in params:
            p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)).cuda()
        cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32)).cuda()
               for _ in range(3)]
        key = f"{len(layers) - 2}x{max(layers)}_k{paths}_n{n}"
        with torch.inference_mode():
            outs = k_taylor1.taylor1(spec, params, x)
            grad = k_taylor1.taylor1_backward(spec, params, x, cot)
            torch.cuda.synchronize()
        for name, t in zip(("y", "y_x", "y_t", "grad"), list(outs) + [grad]):
            saved[f"{key}_{name}"] = t.cpu().numpy()
        row = {"what": "k7a", "net": key, "card": card, "tree": args.tree or "."}
        plan = getattr(k_taylor1, "default_design", None)
        row["design"] = plan(spec.widths) if plan else "wide"
        if args.times:
            with torch.inference_mode():
                row["forward_ms"] = event_ms(torch, lambda: k_taylor1.taylor1(spec, params, x))
                row["backward_ms"] = event_ms(
                    torch, lambda: k_taylor1.taylor1_backward(spec, params, x, cot))
        if args.profile:
            with torch.inference_mode():
                row["forward_profile"] = device_us(
                    torch, lambda: k_taylor1.taylor1(spec, params, x))
                row["backward_profile"] = device_us(
                    torch, lambda: k_taylor1.taylor1_backward(spec, params, x, cot))
        print(json.dumps(row), flush=True)
    for e, n, c, cd in REDUCE:
        rng = np.random.default_rng(352 + e)
        base = rng.standard_normal((1, n, c))
        vals = torch.from_numpy((base + 1e-4 * rng.standard_normal((e, n, c))).astype(
            np.float32)).cuda()
        dx = torch.from_numpy(rng.standard_normal((e, n, cd)).astype(np.float32)).cuda()
        with torch.inference_mode():
            got = k_ens.member_stats(vals, dx)
            torch.cuda.synchronize()
        for name, t in zip(("mean", "std", "dx"), got):
            saved[f"k8s_e{e}_{name}"] = t.cpu().numpy()
        row = {"what": "k8s_reduce", "members": e, "n": n, "fields": c, "dx_fields": cd,
               "card": card, "tree": args.tree or "."}
        if args.times:
            with torch.inference_mode():
                row["kernel_ms"], row["std_mean_ms"] = event_ms_turns(
                    torch, [lambda: k_ens.member_stats(vals, dx),
                            lambda: torch.std_mean(vals, dim=0, correction=0)], 200)
        if args.profile:
            with torch.inference_mode():
                row["kernel_profile"] = device_us(torch, lambda: k_ens.member_stats(vals, dx))
                row["std_mean_profile"] = device_us(
                    torch, lambda: torch.std_mean(vals, dim=0, correction=0))
        print(json.dumps(row), flush=True)
    np.savez(args.save, **saved)
    return 0


def compare(a: str, b: str) -> int:
    with np.load(a) as za, np.load(b) as zb:
        keys = sorted(set(za.files) | set(zb.files))
        for k in keys:
            if k not in za.files or k not in zb.files:
                print(json.dumps({"output": k, "equal": False, "missing": True}))
                continue
            x, y = za[k], zb[k]
            diff = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()) \
                if x.shape == y.shape and x.size else 0.0
            print(json.dumps({"output": k, "equal": bool(np.array_equal(x, y)),
                              "max_abs_diff": diff, "max_abs": float(np.abs(x).max())
                              if x.size else 0.0}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not args.save:
        ap.error("--save FILE is needed")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
