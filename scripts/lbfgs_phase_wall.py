"""The flagship's L-BFGS phase on the card, chunk by chunk: ``abgrall_admm``
from a checkpoint (``--checkpoint``, e.g. the final one of a whole run, for
the late outer epochs) or after ``--adam`` Adam epochs (K3 in K9's graphs),
or at the end of a whole run that it trains first (``--full-run DIR``: its
wall time and its L-BFGS phase's, from the metrics log, are reported too),
then ``--chunks`` chunks of ``--outer`` outer epochs through the trainer's
chunk runner (``ops.kernels.lbfgs.LBFGSChunk``: each solve one launch of its
WHILE-node graph, then K3's post-update mode and the reset in place).

    python scripts/lbfgs_phase_wall.py [--checkpoint C | --adam 50000]
        [--chunks 20] [--outer 10] [--ks 4] [--out FILE]

Prints one JSON line: each outer epoch's iterations; ms an outer epoch
(host clock, each chunk between synchronizes, after one warm-up chunk that
captures the graphs); a second pass with every solve's launch bracketed by
synchronizes, which splits an outer epoch into the solve and the rest (the
post-update replay, the chunk's ravel, loads, reset and hand-back); the
solve launches, steps, steps after the end and host syncs an outer epoch;
one chunk under torch.profiler (device time by kernel, launches, the idle
share: on the card the profiler records the kernels of a solve loop's
first body iteration only, one launch of each an outer epoch, so these are
a lower and an upper bound); the card's name and power limit. Each chunk is
also bracketed by CUDA events (its device span: the device time). With
``--ks 1,4,16`` the timed chunks run at each k (the solve loop's evaluation
steps a body iteration, recaptured), in turns, each from the same state;
the split pass and the profiled chunk run at the first k. Needs one NVIDIA
GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def chunks(run, state, n: int, outer: int, solve_ms=None):
    """``n`` chunks of ``outer`` outer epochs from ``state``: (state, chunk
    ms, iterations). With ``solve_ms`` (a one-item list) every solve's
    launch is bracketed by synchronizes and its ms added to it."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    launch = k_lbfgs.SolveLoop.launch

    def timed(loop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return launch(loop)
        finally:
            torch.cuda.synchronize()
            solve_ms[0] += 1e3 * (time.perf_counter() - t0)

    if solve_ms is not None:
        k_lbfgs.SolveLoop.launch = timed
    walls, spans, iters = [], [], []
    try:
        for _ in range(n):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            state, m = run(state, outer)
            end.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            spans.append(start.elapsed_time(end))
            iters.append(m["lbfgs_iters"])
    finally:
        k_lbfgs.SolveLoop.launch = launch
    return state, walls, [int(v) for v in torch.cat(iters).tolist()], spans


def full_run(out_dir: str):
    """abgrall_admm's whole schedule through Trainer.train into ``out_dir``
    (seed 1234): (final state, {wall s, the L-BFGS phase's s from the
    metrics log's lbfgs rows (each row's ``elapsed`` the host time since the
    row before), outer epochs, u rel-L2})."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {"train.out_dir": out_dir})
    trainer = Trainer(exp, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, summary = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "abgrall_admm_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"summary"' not in line]
    lb = [r for r in rows if r.get("phase") == "lbfgs"]
    return state, {"wall_s": wall, "lbfgs_phase_s": sum(r["elapsed"] for r in lb),
                   "adam_phase_s": sum(r["elapsed"] for r in rows if r.get("phase") == "adam"),
                   "outer_epochs": int(state.epoch) - exp.optimizer.switch_epoch,
                   "rel_l2_u": summary["rel_l2_u"]}


def set_steps(run, k: int) -> None:
    """The chunk runner's solve loop at k steps a body iteration (captured
    anew at its next use, with the post-update graph, whose tally of the
    steps run reads k)."""
    solver = run.runner.solver
    if solver.steps != k:
        solver.steps = k
        solver.loops.clear()
        run.runner.graphs.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--full-run", default=None, metavar="DIR",
                    help="first train the whole schedule into DIR (its wall and its "
                    "L-BFGS phase's from the metrics log), then time from its end")
    ap.add_argument("--adam", type=int, default=50_000)
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--outer", type=int, default=10)
    ap.add_argument("--ks", default=None, help="k values to time in turns (default: the "
                    "solver's own)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lbfgs_phase_wall: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.train.trainer import Trainer
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    exp = override(get_preset("abgrall_admm"), {"train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    full = None
    if args.full_run:
        state, full = full_run(args.full_run)
    elif args.checkpoint:
        state = trainer.load_checkpoint(args.checkpoint)
    else:
        state, _ = trainer.train(epochs=args.adam)
    run = trainer._get_chunk("lbfgs")
    if not isinstance(getattr(run, "runner", None), k_lbfgs.LBFGSChunk):
        raise RuntimeError("abgrall_admm's L-BFGS phase is not on K10's chunk runner")
    start = int(state.epoch)
    ks = [int(v) for v in args.ks.split(",")] if args.ks else [run.runner.solver.steps]
    for k in ks:  # the captures
        set_steps(run, k)
        chunks(run, state, 1, args.outer)
    state, _, _, _ = chunks(run, state, 1, args.outer)
    counters = ("LOOP_LAUNCHES", "LOOP_STEPS", "STEPS_AFTER_END")
    by_k = {k: {"walls": [], "spans": [], "counts": [0, 0, 0, 0]} for k in ks}
    for turn in range(2 if len(ks) > 1 else 1):
        for k in ks:
            set_steps(run, k)
            before = [getattr(k_lbfgs, c) for c in counters] + [host_lbfgs.HOST_SYNCS]
            _, walls, iters, spans = chunks(run, state, args.chunks, args.outer)
            after = [getattr(k_lbfgs, c) for c in counters] + [host_lbfgs.HOST_SYNCS]
            row = by_k[k]
            row["walls"] += walls
            row["spans"] += spans
            row["counts"] = [c + a - b for c, a, b in zip(row["counts"], after, before)]
            row["iters"] = iters
    k0 = ks[0]
    set_steps(run, k0)
    walls, iters, spans = by_k[k0]["walls"], by_k[k0]["iters"], by_k[k0]["spans"]
    n = len(walls) * args.outer
    launches, steps, empty, syncs = by_k[k0]["counts"]
    solve_ms = [0.0]
    state, split_walls, split_iters, _ = chunks(run, state, args.chunks, args.outer, solve_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, prof_walls, prof_iters, _ = chunks(run, state, 1, args.outer)
    by_kernel, copies = {}, 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += us
            continue
        name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
        by_kernel[name] = {"us_per_outer_epoch": us / args.outer,
                           "launches_per_outer_epoch": evt.count / args.outer}
    device_us = sum(k["us_per_outer_epoch"] for k in by_kernel.values()) + copies / args.outer
    row = {
        "card": card, "from_epoch": start, "checkpoint": args.checkpoint, "full_run": full,
        "outer_per_chunk": args.outer, "chunks": args.chunks,
        "lbfgs_iters": iters, "iters_mean": sum(iters) / len(iters),
        "ms_per_outer_epoch": sum(walls) / n, "chunk_ms": walls,
        "chunk_ms_median": statistics.median(walls),
        "event_ms_per_outer_epoch": sum(spans) / n,
        "split": {"ms_per_outer_epoch": sum(split_walls) / n,
                  "solve_ms_per_outer_epoch": solve_ms[0] / n,
                  "outside_solve_ms_per_outer_epoch": (sum(split_walls) - solve_ms[0]) / n,
                  "iters_mean": sum(split_iters) / len(split_iters)},
        "steps_per_body": k0,
        "by_k": {str(k): {
            "ms_per_outer_epoch": sum(r["walls"]) / (len(r["walls"]) * args.outer),
            "event_ms_per_outer_epoch": sum(r["spans"]) / (len(r["walls"]) * args.outer),
            "chunk_ms": r["walls"],
            "steps_per_outer_epoch": r["counts"][1] / (len(r["walls"]) * args.outer),
            "steps_after_end_per_outer_epoch": r["counts"][2] / (len(r["walls"]) * args.outer),
            "host_syncs_per_chunk": r["counts"][3] / len(r["walls"])} for k, r in by_k.items()},
        "solve_launches_per_outer_epoch": launches / n, "steps_per_outer_epoch": steps / n,
        "steps_after_end_per_outer_epoch": empty / n, "host_syncs_per_outer_epoch": syncs / n,
        "host_syncs_per_chunk": syncs * args.outer / n,
        "profiled_chunk": {"wall_ms": prof_walls[0], "iters": prof_iters,
                           "device_us_per_outer_epoch": device_us,
                           "idle_share": 1.0 - device_us * args.outer / (1e3 * prof_walls[0]),
                           "by_kernel": by_kernel},
        "final_epoch": int(state.epoch),
    }
    print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
