"""Where the time of a training epoch goes on the card: torch.profiler over a
chunk of epochs of the trainer's Adam step (the fused CUDA step K3, or the
generic step over the kernels for a configuration outside K3's scope), of the
plain step, and over one L-BFGS outer epoch: the trainer's (K10 inside its
scope, ``ops.kernels.lbfgs.lbfgs_device_supported``) and, with
``lbfgs_host``, the host loop over the kernels under autograd on the same
state.

    python scripts/profile_train_step.py [--preset abgrall_admm] [--epochs 200]
        [--dataset twosin_burgers_shock] [--lbfgs-iters 100]
        [--out chiprun_out/profile_train_step.json]
        [--set KEY=VALUE ...] [--steps adam,plain,lbfgs,lbfgs_host] [--ensemble E] [--graph]

The scale slice: ``--preset burgers_scale --dataset burgers_shock --epochs 3
--steps adam --set model.compute_dtype=bfloat16 --set "model.keep_streams=('xx',)"``.
The Euler slice: ``--preset euler_admm --dataset abgrall_eulers --steps adam,plain``
(an Euler preset has no L-BFGS phase in the port yet). The weak-form slice:
``--preset twosin_weak --steps adam,plain`` and ``--preset euler_inverse
--dataset abgrall_eulers --steps adam,plain``; the shock-path slice:
``--preset euler_weak_fast --dataset abgrall_eulers --steps adam,plain``.
An ensemble: ``--ensemble 8 --steps adam`` profiles the Adam epochs of 8
members (seeds train.seed + i): one K8 call an epoch inside K3's narrow
scope, else the member loop; a unit is then an epoch of all members.
``--graph`` also profiles, in the same process and on the same state, the
fused step's chunk as K9 runs it in training (``train.trainer.make_chunked``:
the epochs replayed from captured CUDA graphs; for an ensemble K8's graphs,
``parallel.ensemble.make_ensemble_chunk``), reported as ``fused_chunk``
beside the per-epoch ``fused_step`` (``fused_chunk_ensemble`` beside
``fused_step_ensemble``); the warm-up epochs before the window capture the
graphs.

For each step it reports, per epoch (per iteration for L-BFGS): the wall time
(host clock, ending in a synchronize), the device time of every kernel by name
(the profiler's CUDA activity), their sum, the sums over K3's, K5's, K7a's,
K7b's and K10's kernels (named in namespaces k3, k5, k7, k7b and k10), the
device's idle share 1 - device time / wall time, the host operations that
took the most CPU time, and the peak device memory of the step (warm-up
included). Needs one NVIDIA GPU; imports no jax.
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


def solo_chunks(step):
    """``run(state, epochs) -> (state, metrics)`` over one step function: the
    per-epoch loop (a stacked state with K8's step too)."""
    from pinns_tpu_torch.train.trainer import run_chunk

    return lambda state, epochs: run_chunk(step, state, epochs)


def profile_chunk(run, state, epochs: int, warmup: int = 5) -> dict:
    """Profile ``run(state, epochs)`` (:func:`solo_chunks`, or an ensemble's
    chunk); numbers are per unit, where a unit is an epoch, or an L-BFGS
    iteration when the step reports lbfgs_iters."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    if warmup:
        run(state, warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = run(state, epochs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    units = int(metrics["lbfgs_iters"].sum()) or epochs
    kernels, host = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = {"us_per_unit": us / units, "calls_per_unit": evt.count / units}
        elif evt.device_type == torch.autograd.DeviceType.CPU and evt.self_cpu_time_total > 0:
            host[evt.key] = {"self_us_per_unit": evt.self_cpu_time_total / units,
                             "calls_per_unit": evt.count / units}
    device_us = sum(k["us_per_unit"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per_unit"])[:12])
    # K3 (csrc/fused_step.cu), K5 (csrc/mlp_forward.cu), K7a
    # (csrc/taylor1.cu) and K7b (csrc/weakform.cu): every kernel and engine
    # instantiation of each is named in namespace k3, k5, k7 or k7b
    named = {}
    for ns in ("k3", "k5", "k7", "k7b", "k10"):
        mine = {name: k for name, k in kernels.items() if f"{ns}::" in name}
        named.update({f"{ns}_us_per_unit": sum(k["us_per_unit"] for k in mine.values()),
                      f"{ns}_kernels_per_unit": sum(k["calls_per_unit"] for k in mine.values()),
                      f"{ns}_kernels": mine})
    top_host = dict(sorted(host.items(), key=lambda kv: -kv[1]["self_us_per_unit"])[:15])
    return {"units": units, "unit": "lbfgs_iteration" if units != epochs else "epoch",
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "wall_us_per_unit": wall_us / units, "device_us_per_unit": device_us,
            "idle_share": 1.0 - device_us / (wall_us / units),
            "kernels_per_unit": sum(k["calls_per_unit"] for k in kernels.values()),
            **named, "top_kernels": top, "top_host_ops": top_host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="abgrall_admm")
    ap.add_argument("--dataset", default="twosin_burgers_shock")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lbfgs-iters", type=int, default=100,
                    help="iteration cap of the profiled L-BFGS outer epoch")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="override a config field, as the train CLI's --set")
    ap.add_argument("--steps", default="adam,plain,lbfgs",
                    help="which of adam, plain, lbfgs, lbfgs_host to profile (comma-separated)")
    ap.add_argument("--ensemble", type=int, default=1, metavar="E",
                    help="profile the Adam epochs of an E-member ensemble")
    ap.add_argument("--graph", action="store_true",
                    help="also profile the fused step's chunk replayed from CUDA graphs (K9)")
    ap.add_argument("--out", default="chiprun_out/profile_train_step.json")
    args = ap.parse_args(argv)
    steps = set(args.steps.split(","))
    if not torch.cuda.is_available():
        print("profile_train_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.cli import parse_sets
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels.fused_step import fused_step_supported
    from pinns_tpu_torch.train.trainer import Trainer, make_adam_step, make_lbfgs_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    exp = override(get_preset(args.preset), {"optimizer.lbfgs.max_iters": args.lbfgs_iters,
                                             **parse_sets(args.set)})
    trainer = Trainer(exp, device="cuda", dataset=args.dataset)
    state = trainer.init_state()
    adam = "generic_step" if fused_step_supported(exp, trainer.problem.spec) else "fused_step"
    result = {"card": card, "preset": args.preset, "epochs": args.epochs, "set": args.set,
              "layers": list(trainer.problem.spec.layers), "n_colloc": int(state.colloc.shape[0]),
              "members": args.ensemble}
    graph = None
    if "adam" in steps and args.ensemble > 1:
        from pinns_tpu_torch.ops.kernels.fused_step import make_fused_ensemble_step
        from pinns_tpu_torch.parallel.ensemble import (
            batched_on_card,
            init_ensemble_states,
            make_ensemble_chunk,
        )

        stacked = init_ensemble_states(
            trainer, [exp.train.seed + i for i in range(args.ensemble)])
        ensemble_chunk = lambda s, n: make_ensemble_chunk(trainer, n)(s)  # noqa: E731
        if batched_on_card(trainer):
            adam = "fused_step_ensemble"
            per_epoch = solo_chunks(make_fused_ensemble_step(trainer.problem,
                                                             trainer.learning_rate))
            if args.graph:
                graph = "fused_chunk_ensemble"
                result[graph] = profile_chunk(ensemble_chunk, stacked, args.epochs,
                                              warmup=min(5, args.epochs))
        else:
            adam, per_epoch = "member_loop", ensemble_chunk
        result[adam] = profile_chunk(per_epoch, stacked, args.epochs, warmup=min(5, args.epochs))
    elif "adam" in steps:
        result[adam] = profile_chunk(solo_chunks(trainer._adam_step), state, args.epochs,
                                     warmup=min(5, args.epochs))
        if args.graph and adam == "fused_step":
            graph = "fused_chunk"
            result[graph] = profile_chunk(trainer._get_chunk("adam"), state, args.epochs,
                                          warmup=min(5, args.epochs))
    if "plain" in steps:
        result["plain_step"] = profile_chunk(
            solo_chunks(make_adam_step(trainer.problem, trainer.learning_rate, plain=True)),
            state, max(1, args.epochs // 10))
    if "lbfgs" in steps:
        # K10 captures its graph in its first solve: one outer epoch before the window
        result["lbfgs_step"] = profile_chunk(
            solo_chunks(trainer._lbfgs_step), state, 1,
            warmup=int(trainer._lbfgs_step.solver is not None))
        result["lbfgs_step"]["solver"] = "k10" if trainer._lbfgs_step.solver else "host_loop"
    if "lbfgs_host" in steps:
        result["lbfgs_host_loop"] = profile_chunk(
            solo_chunks(make_lbfgs_step(trainer.problem, host_loop=True)), state, 1, warmup=0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for name in (n for n in (adam, graph, "plain_step", "lbfgs_step", "lbfgs_host_loop")
                 if n in result):
        r = result[name]
        print(json.dumps({"preset": args.preset, "step": name, "card": card,
                          "members": args.ensemble if name in (adam, graph) else 1,
                          **{k: r[k] for k in ("unit", "units", "wall_us_per_unit",
                                               "device_us_per_unit", "idle_share",
                                               "kernels_per_unit", "k3_us_per_unit",
                                               "k3_kernels_per_unit", "k5_us_per_unit",
                                               "k7_us_per_unit", "k7b_us_per_unit",
                                               "k7b_kernels_per_unit", "k10_us_per_unit",
                                               "k10_kernels_per_unit",
                                               "peak_device_bytes")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
