"""Where the time of a training epoch goes on the card: torch.profiler over a
chunk of epochs of the fused CUDA step and of the plain step.

    python scripts/profile_train_step.py [--preset abgrall_admm] [--epochs 200]
        [--out chiprun_out/profile_train_step.json]

For each step it reports, per epoch: the wall time of the chunk (host clock,
ending in a synchronize), the device time of every kernel by name (the
profiler's CUDA activity), their sum, and the device's idle share
1 - device time / wall time. Needs one NVIDIA GPU; imports no jax.
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


def profile_chunk(step, state, epochs: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from pinns_tpu_torch.train.trainer import run_chunk

    run_chunk(step, state, 5)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chunk(step, state, epochs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = {"us_per_epoch": us / epochs, "calls_per_epoch": evt.count / epochs}
    device_us = sum(k["us_per_epoch"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per_epoch"])[:12])
    return {"wall_us_per_epoch": wall_us / epochs, "device_us_per_epoch": device_us,
            "idle_share": 1.0 - device_us / (wall_us / epochs),
            "kernels_per_epoch": sum(k["calls_per_epoch"] for k in kernels.values()),
            "top_kernels": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="abgrall_admm")
    ap.add_argument("--dataset", default="twosin_burgers_shock")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out/profile_train_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.trainer import Trainer, make_adam_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    trainer = Trainer(get_preset(args.preset), device="cuda", dataset=args.dataset)
    state = trainer.init_state()
    result = {"card": card, "preset": args.preset, "epochs": args.epochs,
              "layers": list(trainer.problem.spec.layers), "n_f": trainer.exp.sampling.n_f,
              "fused_step": profile_chunk(trainer._adam_step, state, args.epochs),
              "plain_step": profile_chunk(
                  make_adam_step(trainer.problem, trainer.learning_rate), state,
                  max(1, args.epochs // 10))}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for name in ("fused_step", "plain_step"):
        r = result[name]
        print(json.dumps({"preset": args.preset, "step": name, "card": card,
                          **{k: r[k] for k in ("wall_us_per_epoch", "device_us_per_epoch",
                                               "idle_share", "kernels_per_epoch")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
