"""Train ``burgers_scale`` on the card under a time budget and record quality
along the way: the quality-of-record run of the scale slice.

    python scripts/scale_quality_run.py --policy keep_xx --epochs 3000 \
        --budget-s 2700 --out runs/scale_quality_keep_xx.jsonl

Runs ``Trainer.train`` of the port (the preset at full size: 8x200, 1,048,576
collocation points a step in 128 microbatches) in stretches of ``--eval-every``
epochs; after each it writes one JSON line: epoch, wall seconds, the last
logged loss and the u rel-L2 on the full burgers_shock grid. It stops at
``--epochs``, or before a stretch that would end past ``--budget-s`` (judged by
the slowest stretch so far). The first line names the card and its power
limit (``nvidia-smi``).

Policies: the overrides of ``experiments.presets.STREAM_POLICIES`` (``f32``,
``keep_xx``, ``keep_none``, ``max``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinns_tpu_torch.experiments.presets import STREAM_POLICIES  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", choices=sorted(STREAM_POLICIES), default="keep_xx")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--budget-s", type=float, default=2700.0)
    ap.add_argument("--out", required=True, help="JSON lines go here")
    args = ap.parse_args(argv)

    import torch

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        print("scale_quality_run: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    exp = override(get_preset("burgers_scale"), dict(STREAM_POLICIES[args.policy], **{
        "train.epochs": args.epochs, "train.seed": args.seed, "train.log_every": args.eval_every}))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        def write(**row):
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)

        write(card=card, policy=args.policy, seed=args.seed, epochs=args.epochs,
              n_f=exp.sampling.n_f, microbatch=exp.sampling.microbatch,
              layers=list(exp.model.layers))
        trainer = Trainer(exp, device="cuda")
        last = {}  # the trainer's last logged metrics
        log = trainer.logger.log
        trainer.logger.log = lambda **record: (last.update(record), log(**record))
        t0 = time.perf_counter()
        state = trainer.init_state()
        slowest = 0.0
        while state.epoch < args.epochs:
            if time.perf_counter() - t0 + slowest > args.budget_s:
                write(stopped="time budget", epoch=int(state.epoch),
                      wall_s=time.perf_counter() - t0)
                break
            t1 = time.perf_counter()
            state, summary = trainer.train(state, epochs=min(state.epoch + args.eval_every,
                                                             args.epochs))
            slowest = max(slowest, time.perf_counter() - t1)
            write(epoch=int(state.epoch), wall_s=time.perf_counter() - t0,
                  stretch_s=time.perf_counter() - t1, loss=last.get("loss"),
                  rel_l2_u=summary["rel_l2_u"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
