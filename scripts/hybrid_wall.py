"""The hybrid phase's L-BFGS outer epochs on the card, K10 beside the host
loop: ``abgrall_admm`` trained for ``--adam`` Adam epochs (K3 in K9's
graphs), then from that one state ``--outer`` L-BFGS outer epochs of at most
``--max-iters`` iterations each, in turns: the trainer's step (K10,
``ops.kernels.lbfgs.DeviceLBFGS``) and the host loop
(``train.trainer.make_lbfgs_step(host_loop=True)``: ``opt.lbfgs`` over the
kernels under autograd). The defaults are ``chip_smoke.py`` phase 14's
schedule (the fixture's: 10,000 Adam epochs, 10 outer epochs of at most 300
iterations).

    python scripts/hybrid_wall.py [--adam 10000] [--outer 10] [--max-iters 300]
        [--turns k10,host,k10] [--out FILE]

Prints one JSON line a turn: the wall seconds of the outer epochs (host
clock, ending in a synchronize), each outer epoch's iterations, the seconds
an iteration, the host syncs of the solves (``opt.lbfgs.HOST_SYNCS``), the
final u rel-L2, and the card's name and power limit. Needs one
NVIDIA GPU; imports no jax. ``--out`` also writes the lines as one JSON
list.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--adam", type=int, default=10_000)
    ap.add_argument("--outer", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--turns", default="k10,host,k10")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hybrid_wall: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.train.trainer import Trainer, make_lbfgs_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    base = get_preset("abgrall_admm")
    adam_exp = override(base, {"train.epochs": args.adam, "optimizer.switch_epoch": args.adam,
                               "train.log_every": 0})
    state, _ = Trainer(adam_exp, device="cuda").train()
    exp = override(base, {"train.epochs": args.adam + args.outer,
                          "optimizer.switch_epoch": args.adam,
                          "optimizer.lbfgs.max_iters": args.max_iters, "train.log_every": 0})
    rows = []
    for turn in args.turns.split(","):
        trainer = Trainer(exp, device="cuda")
        step = trainer._lbfgs_step if turn == "k10" else make_lbfgs_step(trainer.problem,
                                                                         host_loop=True)
        if turn == "k10" and step.solver is None:
            raise RuntimeError("abgrall_admm's L-BFGS step is not on K10")
        iters = []

        def counted(st, out=None, new_colloc=None, step=step, iters=iters):
            st, m = step(st, out, new_colloc)
            iters.append(int(m["lbfgs_iters"]))
            return st, m

        trainer._lbfgs_step = counted
        syncs = host_lbfgs.HOST_SYNCS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, summary = trainer.train(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"turn": turn, "card": card, "adam_epochs": args.adam, "outer": len(iters),
               "max_iters": args.max_iters, "wall_s": wall, "lbfgs_iters": iters,
               "s_per_iter": wall / max(1, sum(iters)),
               "host_syncs": host_lbfgs.HOST_SYNCS - syncs,
               "rel_l2_u": summary["rel_l2_u"], "final_epoch": final.epoch}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
