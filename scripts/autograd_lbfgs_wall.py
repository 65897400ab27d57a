"""Time AutogradLBFGS's two drives on the card over L-BFGS phases: the
captured solve (each solve one launch of its WHILE-node loop, its evaluation
captured anew for every solve) against the host-stepped drive
(``captured=False``: the evaluation launched step by step from the host, the
done flag read every 16 steps), each from the same Adam state:

  burgers_inverse  the preset's whole L-BFGS phase (its outer epochs of up
                   to 20,000 iterations, many of them short late in the
                   phase) after its Adam epochs (``optimizer.switch_epoch``);
  euler_weak_tail  a shortened tail: TAIL_OUTER outer epochs of at most
                   TAIL_MAX_ITERS iterations from euler_weak_fast at
                   TAIL_ADAM Adam epochs (its cosine schedule cut to them).

    python scripts/autograd_lbfgs_wall.py [--out autograd_lbfgs_wall.json]

The kernels' libraries are built first. Each phase runs its outer epochs
(``train.trainer.make_lbfgs_step``) on the captured drive, then on the
host-stepped one: per outer epoch its iterations, wall seconds (host clock,
synchronised), host syncs and the seconds of its captures; the two drives'
final params must be bit-equal.
Prints a JSON line per phase and writes them, with the card's name and
power limit, to ``--out``. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# the libraries the two phases launch, built before anything is timed (a
# library is otherwise built at its first launch, inside the first drive)
KERNELS = ("taylor2", "taylor2_backward", "mlp_forward", "taylor1", "weakform", "sampling",
           "lbfgs")
TAIL_ADAM = 2_000
TAIL_OUTER = 4
TAIL_MAX_ITERS = 300
DRIVES = ("captured", "host_stepped")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def run_drive(problem, state, outer: int, captured: bool) -> tuple:
    """``outer`` outer epochs of the trainer's L-BFGS step from ``state`` on
    one drive: (the last state, the drive's row)."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train import trainer as tr

    step = tr.make_lbfgs_step(problem)
    solver = step.solver
    if not isinstance(solver, k_lbfgs.AutogradLBFGS) or not solver.captured:
        raise RuntimeError(f"the L-BFGS solver is {solver!r}, not K10's captured autograd one")
    solver.captured = captured
    rows = []
    for i in range(outer):
        syncs, captures = lb_mod.HOST_SYNCS, len(solver.capture_seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"outer": i, "n_iters": int(float(m["lbfgs_iters"])), "wall_s": wall,
                     "host_syncs": lb_mod.HOST_SYNCS - syncs,
                     "capture_s": sum(solver.capture_seconds[captures:]),
                     "loss": float(m["loss"])})
    iters = sum(r["n_iters"] for r in rows)
    wall = sum(r["wall_s"] for r in rows)
    return state, {"wall_s": wall, "n_iters": iters, "ms_per_iter": 1e3 * wall / max(iters, 1),
                   "host_syncs": sum(r["host_syncs"] for r in rows),
                   "capture_s": sum(r["capture_s"] for r in rows), "outer_epochs": rows}


def compare(name: str, problem, state, outer: int) -> dict:
    """Both drives from ``state``; their final params bit-equal."""
    from pinns_tpu_torch.opt.lbfgs import ravel_tree

    ends, out = {}, {"phase": name, "outer_epochs": outer}
    for drive in DRIVES:
        ends[drive], out[drive] = run_drive(problem, state, outer, drive == "captured")
    a, b = (ravel_tree(ends[d].params)[0] for d in DRIVES)
    if not torch.equal(a, b):
        raise RuntimeError(f"{name}: the captured drive's params differ from the host-stepped "
                           f"drive's by {float((a - b).abs().max())}")
    out["bit_equal"] = True
    out["host_stepped_over_captured"] = out["host_stepped"]["wall_s"] / out["captured"]["wall_s"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="autograd_lbfgs_wall.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autograd_lbfgs_wall: needs a CUDA device", file=sys.stderr)
        return 1
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import build
    from pinns_tpu_torch.train.trainer import Trainer

    build.prebuild(KERNELS)
    out = {"card": card(), "torch": torch.__version__}
    exp = override(get_preset("burgers_inverse"), {"train.log_every": 0})
    inverse = Trainer(exp, device="cuda")
    t0 = time.perf_counter()
    state, _ = inverse.train(epochs=exp.optimizer.switch_epoch)
    torch.cuda.synchronize()
    out["burgers_inverse"] = {
        "adam_epochs": int(state.epoch), "adam_wall_s": time.perf_counter() - t0,
        **compare("burgers_inverse", inverse.problem, state,
                  exp.train.epochs - exp.optimizer.switch_epoch)}
    print(json.dumps({**out["burgers_inverse"], "card": out["card"]}), flush=True)

    fast = Trainer(override(get_preset("euler_weak_fast"), {
        "train.epochs": TAIL_ADAM, "optimizer.schedule_epochs": TAIL_ADAM,
        "train.log_every": 0}), device="cuda")
    state, _ = fast.train()
    start = int(state.epoch)
    tail = Trainer(override(get_preset("euler_weak_tail"), {
        "optimizer.switch_epoch": start, "train.epochs": start + TAIL_OUTER,
        "optimizer.lbfgs.max_iters": TAIL_MAX_ITERS}), device="cuda")
    out["euler_weak_tail"] = {"adam_epochs": start, "max_iters": TAIL_MAX_ITERS,
                              **compare("euler_weak_tail", tail.problem, state, TAIL_OUTER)}
    print(json.dumps({**out["euler_weak_tail"], "card": out["card"]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
