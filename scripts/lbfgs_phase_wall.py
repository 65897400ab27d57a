"""The flagship's L-BFGS phase on the card, chunk by chunk: ``abgrall_admm``
from a checkpoint (``--checkpoint``, e.g. the final one of a whole run, for
the late outer epochs) or after ``--adam`` Adam epochs (K3 in K9's graphs),
then ``--chunks`` chunks of ``--outer`` outer epochs through the trainer's
chunk runner (``ops.kernels.lbfgs.LBFGSChunk``: each solve replayed to its
done flag, then K3's post-update mode and the reset in place).

    python scripts/lbfgs_phase_wall.py [--checkpoint C | --adam 50000]
        [--chunks 20] [--outer 10] [--out FILE]

Prints one JSON line: each outer epoch's iterations; ms an outer epoch
(host clock, each chunk between synchronizes, after one warm-up chunk that
captures the graphs); a second pass with every solve's replays bracketed by
synchronizes, which splits an outer epoch into the solve and the rest (the
post-update replay, the chunk's ravel, loads, reset and hand-back); the
solve replays and host syncs an outer epoch; one chunk under torch.profiler
(device time by kernel, launches, the idle share); the card's name and power
limit. Needs one NVIDIA GPU; imports no jax.
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
    replays are bracketed by synchronizes and their ms added to it."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    replay = k_lbfgs.DeviceLBFGS.replay_until_done

    def timed(solver, graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return replay(solver, graph)
        finally:
            torch.cuda.synchronize()
            solve_ms[0] += 1e3 * (time.perf_counter() - t0)

    if solve_ms is not None:
        k_lbfgs.DeviceLBFGS.replay_until_done = timed
    walls, iters = [], []
    try:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run(state, outer)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            iters.append(m["lbfgs_iters"])
    finally:
        k_lbfgs.DeviceLBFGS.replay_until_done = replay
    return state, walls, [int(v) for v in torch.cat(iters).tolist()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--adam", type=int, default=50_000)
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--outer", type=int, default=10)
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
    if args.checkpoint:
        state = trainer.load_checkpoint(args.checkpoint)
    else:
        state, _ = trainer.train(epochs=args.adam)
    run = trainer._get_chunk("lbfgs")
    if not isinstance(getattr(run, "runner", None), k_lbfgs.LBFGSChunk):
        raise RuntimeError("abgrall_admm's L-BFGS phase is not on K10's chunk runner")
    start = int(state.epoch)
    state, _, _ = chunks(run, state, 1, args.outer)  # the captures
    replays, syncs = k_lbfgs.GRAPH_REPLAYS, host_lbfgs.HOST_SYNCS
    state, walls, iters = chunks(run, state, args.chunks, args.outer)
    n = args.chunks * args.outer
    replays, syncs = k_lbfgs.GRAPH_REPLAYS - replays, host_lbfgs.HOST_SYNCS - syncs
    solve_ms = [0.0]
    state, split_walls, split_iters = chunks(run, state, args.chunks, args.outer, solve_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, prof_walls, prof_iters = chunks(run, state, 1, args.outer)
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
        "card": card, "from_epoch": start, "checkpoint": args.checkpoint,
        "outer_per_chunk": args.outer, "chunks": args.chunks,
        "lbfgs_iters": iters, "iters_mean": sum(iters) / len(iters),
        "ms_per_outer_epoch": sum(walls) / n, "chunk_ms": walls,
        "chunk_ms_median": statistics.median(walls),
        "split": {"ms_per_outer_epoch": sum(split_walls) / n,
                  "solve_ms_per_outer_epoch": solve_ms[0] / n,
                  "outside_solve_ms_per_outer_epoch": (sum(split_walls) - solve_ms[0]) / n,
                  "iters_mean": sum(split_iters) / len(split_iters)},
        "solve_replays_per_outer_epoch": replays / n, "host_syncs_per_outer_epoch": syncs / n,
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
