"""Time the Euler L-BFGS tail on the card: euler_weak_tail's outer epochs from
a euler_weak_fast checkpoint, one at a time, until a wall budget.

The best Euler workflow trains a euler_weak_fast ensemble, resumes each
member with euler_weak_tail (50 L-BFGS outer epochs of up to 5,000
iterations each) and picks a member with ``export --select rank``. This
script measures one member's tail as the port runs it on the card (each
solve on K10's kernels around autograd through the loss,
``ops.kernels.lbfgs.AutogradLBFGS``): for each outer epoch its iterations,
its wall seconds (host clock, synchronised), its final loss and the rel-L2 of
rho, u and E on the native grid, beside the Adam member's rel-L2 it started
from.

    python scripts/euler_tail_wall.py [--checkpoint CKPT | --adam-epochs 20000]
        [--budget-s 1200] [--out euler_tail_wall.json]

Without ``--checkpoint`` it first trains euler_weak_fast at seed 1234 with
its cosine schedule cut to ``--adam-epochs`` (epochs and schedule_epochs).
The JSON names the card and its power limit. Needs a CUDA device.
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

FIELDS = ("rho", "u", "E")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", help="a euler_weak_fast checkpoint to resume")
    ap.add_argument("--adam-epochs", type=int, default=20_000)
    ap.add_argument("--budget-s", type=float, default=1_200.0,
                    help="stop starting outer epochs after this many seconds of the tail")
    ap.add_argument("--outer", type=int, default=50, help="outer epochs at most")
    ap.add_argument("--out", default="euler_tail_wall.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("euler_tail_wall: needs a CUDA device", file=sys.stderr)
        return 1
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train.trainer import Trainer

    out = {"card": card(), "torch": torch.__version__}
    t0 = time.perf_counter()
    if args.checkpoint:
        fast = Trainer(get_preset("euler_weak_fast"), device="cuda")
        state = fast.load_checkpoint(args.checkpoint)
        out["start"] = {"checkpoint": args.checkpoint, **fast.evaluate(state)}
    else:
        a = args.adam_epochs
        fast = Trainer(override(get_preset("euler_weak_fast"), {
            "train.epochs": a, "optimizer.schedule_epochs": a, "train.log_every": 0}),
            device="cuda")
        state, summary = fast.train()
        torch.cuda.synchronize()
        out["start"] = {"adam_epochs": a, "adam_wall_s": time.perf_counter() - t0, **summary}
    print(json.dumps({"start": out["start"]}), flush=True)
    start = int(state.epoch)
    tail = Trainer(override(get_preset("euler_weak_tail"), {
        "optimizer.switch_epoch": start, "train.epochs": start + args.outer}), device="cuda")
    step = tail._lbfgs_step
    if not isinstance(step.solver, k_lbfgs.AutogradLBFGS):
        raise RuntimeError(f"the tail's solver is {step.solver!r}, not K10 over autograd")
    epochs = []
    t_tail = time.perf_counter()
    for i in range(args.outer):
        if time.perf_counter() - t_tail > args.budget_s:
            break
        syncs = lb_mod.HOST_SYNCS
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        iters = int(float(m["lbfgs_iters"]))
        row = {"outer": i, "epoch": int(state.epoch), "n_iters": iters, "wall_s": wall,
               "ms_per_iter": 1e3 * wall / max(iters, 1), "loss": float(m["loss"]),
               "host_syncs": lb_mod.HOST_SYNCS - syncs,
               **{k: v for k, v in tail.evaluate(state).items() if k.startswith("rel_l2")}}
        epochs.append(row)
        print(json.dumps(row), flush=True)
    out.update({"outer_epochs": epochs, "tail_wall_s": time.perf_counter() - t_tail,
                "budget_s": args.budget_s, "max_iters": tail.exp.optimizer.lbfgs.max_iters})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"outer_epochs_done": len(epochs), "tail_wall_s": out["tail_wall_s"],
                      "card": out["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
