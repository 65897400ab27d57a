"""The quality runs of record for the Burgers presets on the card: ``train``
of a preset at its full schedule, then ``polish`` of its final checkpoint,
both through the port's CLI, with the card's name and power limit.

    python scripts/polish_quality_run.py --preset burgers_forward --max-iters 8000 \
        --out-dir runs/quality [--seed 1234] [--device cuda]

prints one JSON line per stage (train, polish) with the CLI's summary, the
wall time of the command, and for ``burgers_inverse`` the errors of the
identified coefficients against the truth (lambda1 = 1, nu = 0.01/pi) in
percent, then a last line with both stages side by side. The bars: u
rel-L2 <= 1e-3 for burgers_forward, both coefficient errors < 1% for
burgers_inverse. JAX's numbers beside them (its CPU polish) are in
``PARITY.md:209-214``.

With ``--train-only`` the polish stage is left out; ``--seeds`` runs the
train (and polish) stages for several seeds in turn, each into its own
``<out-dir>/s<seed>``, and ends with a line of the seeds' u rel-L2 and their
median after the train stage (the five-seed study of ROADMAP P6):

    python scripts/polish_quality_run.py --preset burgers_forward --max-iters 0 \
        --train-only --seeds 1234,7,99,1235,1236 --out-dir runs/p6

With ``--adam-only`` the train stage stops at the preset's switch to
L-BFGS (``--epochs optimizer.switch_epoch``), and two stages run between it
and the polish, each from that one Adam state: the preset's float32 L-BFGS
outer epochs as training runs them (``make_lbfgs_step``, K10 on the card),
and the same on the host loop (``host_loop=True``, the JAX package's
algorithm), each with its iterations and loss an outer epoch, u rel-L2 and
wall time. The polish then starts from the Adam state.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NU = 0.01 / math.pi  # the Burgers viscosity of the reference data


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def _cli(argv) -> tuple:
    """Run ``python -m pinns_tpu_torch argv``: (its stdout lines, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pinns_tpu_torch", *argv], cwd=ROOT,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{argv[0]} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines(), wall


def _coeff_errors(summary: dict) -> dict:
    return {"lambda1_err_pct": 100.0 * abs(summary["lambda1"] - 1.0),
            "nu_err_pct": 100.0 * abs(summary["lambda2"] - NU) / NU}


def _lbfgs_stages(args, exp, ckpt):
    """The preset's float32 L-BFGS outer epochs from the checkpoint, on K10
    and on the host loop: stage name -> row."""
    import torch

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.train import trainer as tr

    exp = override(exp, {"train.seed": args.seed})
    trainer = tr.Trainer(exp, device=args.device)
    out = {}
    for name, host_loop in (("lbfgs_k10", False), ("lbfgs_host_loop", True)):
        step = tr.make_lbfgs_step(trainer.problem, host_loop=host_loop)
        state = trainer.load_checkpoint(ckpt)
        rows = []
        t0 = time.perf_counter()
        for _ in range(exp.train.epochs - exp.optimizer.switch_epoch):
            state, metrics = step(state)
            rows.append({"epoch": int(state.epoch), "loss": float(metrics["loss"]),
                         "lbfgs_iters": int(metrics["lbfgs_iters"])})
        if args.device == "cuda":
            torch.cuda.synchronize()
        out[name] = {"summary": trainer.evaluate(state), "wall_s": time.perf_counter() - t0,
                     "solver": type(step.solver).__name__, "outer_epochs": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", required=True, choices=("burgers_forward", "burgers_inverse"))
    ap.add_argument("--max-iters", type=int, required=True, help="polish's iteration cap")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a config override for both commands (a cut-down run)")
    ap.add_argument("--adam-only", action="store_true",
                    help="train the Adam phase alone, then the float32 L-BFGS stages")
    ap.add_argument("--train-only", action="store_true", help="leave out the polish stage")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds, each run in turn into <out-dir>/s<seed>")
    args = ap.parse_args(argv)
    if args.seeds:
        seeds = [int(v) for v in args.seeds.split(",")]
        errs = []
        for seed in seeds:
            errs.append(_run_one(argparse.Namespace(**dict(
                vars(args), seed=seed, out_dir=os.path.join(args.out_dir, f"s{seed}")))))
        print(json.dumps({"preset": args.preset, "seeds": seeds, "card": _card(),
                          "train_rel_l2_u": errs, "median": float(sorted(errs)[len(errs) // 2])}),
              flush=True)
        return 0
    _run_one(args)
    return 0


def _run_one(args) -> float:
    """The stages of one seed; returns u rel-L2 after the train stage."""
    card = _card()
    sets = [a for kv in args.set for a in ("--set", kv)]
    out = {}

    def report(stage):
        row = out[stage]
        if args.preset == "burgers_inverse":
            row.update(_coeff_errors(row["summary"]))
        print(json.dumps({"stage": stage, "preset": args.preset, "seed": args.seed,
                          "card": card, **row}), flush=True)

    epochs = []
    if args.adam_only:
        from pinns_tpu_torch.cli import parse_sets
        from pinns_tpu_torch.config import override
        from pinns_tpu_torch.experiments import get_preset

        exp = override(get_preset(args.preset), parse_sets(args.set))
        epochs = ["--epochs", str(exp.optimizer.switch_epoch)]
    lines, wall = _cli(["train", "--preset", args.preset, *sets, *epochs, "--seed",
                        str(args.seed), "--out-dir", args.out_dir, "--device", args.device])
    out["train"] = {"summary": json.loads(lines[-1]), "wall_s": wall}
    report("train")
    if args.train_only:
        return out["train"]["summary"]["rel_l2_u"]
    ckpt = os.path.join(args.out_dir, f"{args.preset}_final.ckpt")
    if args.adam_only:
        out.update(_lbfgs_stages(args, exp, ckpt))
        report("lbfgs_k10")
        report("lbfgs_host_loop")
    lines, wall = _cli(["polish", "--preset", args.preset, *sets, "--checkpoint", ckpt,
                        "--max-iters", str(args.max_iters), "--device", args.device])
    head = lines[-3]  # "f64 L-BFGS: N iters, loss L, converged=C"
    iters = int(head.split(":")[1].split("iters")[0])
    out["polish"] = {"summary": json.loads(lines[-2]), "wall_s": wall, "line": head,
                     "iters": iters, "checkpoint": lines[-1]}
    report("polish")
    print(json.dumps({"preset": args.preset, "seed": args.seed, "card": card,
                      "max_iters": args.max_iters,
                      **{f"{stage}_{k}": v for stage in ("train", "polish")
                         for k, v in out[stage].items() if k != "summary"},
                      **{f"{stage}_rel_l2_u": out[stage]["summary"]["rel_l2_u"]
                         for stage in ("train", "polish")}}), flush=True)
    return out["train"]["summary"]["rel_l2_u"]


if __name__ == "__main__":
    sys.exit(main())
