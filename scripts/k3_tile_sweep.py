"""Time the fused Adam epoch (K3, ``csrc/fused_step.cu``) on the card: weigh
the wide design's split of dW (``ops/kernels/fused_step.py::SPLIT_BLOCKS``)
in time and in accuracy, and hold one tree's epochs and training chunks
against another's.

    python scripts/k3_tile_sweep.py [--nets 8x20,8x200] [--n-f 1000,4000]
        [--n-u 100] [--kinds admm,l1_sq_norm] [--split-blocks 396,800,1600]
        [--narrow-tiles 8,4] [--lr 1e-3] [--reps 20] [--f64] [--profile]
        [--tree DIR] [--save FILE]
    python scripts/k3_tile_sweep.py --chunk 1000 [--chunk-reps 3] [--nets ...]
        [--reps 20] [--tree DIR]
    python scripts/k3_tile_sweep.py --compare A.npz B.npz

Prints the card's name and power limit, then one JSON line per (net, N_f,
kind, split target): the CUDA-event median of ``--reps`` epochs after
warm-up (one host call each, host work included) and the plan.
``--split-blocks`` times the wide design at each of these targets for the
blocks of dW's split, ``--narrow-tiles`` the narrow design at each of these
grad-kernel tiles (``--tree`` runs its own plan). ``--f64`` adds each gradient leaf's error against the float64
hand-written reverse mode (``loss_and_grad_reference``) over the float32
one's error, and the worst leaf. ``--profile`` adds an epoch's device time,
summed over its kernels by torch.profiler, its kernel count and its kernels'
times. ``--save FILE`` writes every epoch's outputs (params, mu, nu, colloc,
z, dual, metrics, grad) to an ``.npz``, so that two trees' outputs can be
compared bit for bit; ``--lr 0`` keeps the params, so that the tail's
outputs (colloc, z, dual) of two trees compare whatever their gradients.
``--compare A B`` prints, for every array the two files share, whether they
are equal bit for bit and their largest difference. Random weights and
inputs from seeds (abgrall_l1's and abgrall_admm's settings: lambda1 1,
lambda2 0, rho 10, lr 1e-3).

``--chunk N`` times the trainer's own step instead, as ``chip_smoke.py``'s
times phase does: for each net (8x20: ``abgrall_admm`` on its grid; 8x200:
``abgrall_l1`` on the TwoSin grid) one epoch by CUDA events (the median of
``--reps``) and ``--chunk-reps`` chunks of N epochs by the host clock
(``run_chunk``, one sync a chunk).

``--tree DIR`` runs the package of another checkout (an older commit
unpacked with ``git archive``); alternate processes of both trees to compare
them on one card. Needs one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NETS = {"8x20": (2,) + (20,) * 8 + (1,), "8x200": (2,) + (200,) * 8 + (1,)}
# the trainer's step at each net, as chip_smoke.py's times phase runs it
CHUNK_PRESETS = {"8x20": ("abgrall_admm", None), "8x200": ("abgrall_l1", "twosin_burgers_shock")}


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, calls: int = 20):
    """(device microseconds, kernels, {kernel: microseconds}) per call of
    ``fn``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel, count = {}, 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = t / calls
            count += evt.count
    return sum(by_kernel.values()), count / calls, by_kernel


def f64_ratios(k3, spec, flat, grad, x_data, u_data, colloc, z, dual, kind) -> dict:
    """Per gradient leaf: the kernel's max error against the float64 reverse
    mode over the float32 reverse mode's, and the worst leaf."""

    def leaves(dtype):
        sp = dataclasses.replace(spec, dtype=dtype)
        cast = lambda t: None if t is None else t.to(dtype)  # noqa: E731
        net = k3.unpack_params(flat.to(dtype), spec.layers)
        _, _, _, g = k3.loss_and_grad_reference(
            sp, net, cast(x_data), cast(u_data), cast(colloc), cast(z), cast(dual), kind=kind,
            lam1=1.0, lam2=0.0, rho=10.0)
        return [t.reshape(-1).double() for t in g]

    exact, plain = leaves(torch.float64), leaves(torch.float32)
    got = [t.reshape(-1).double() for l in k3.unpack_params(grad, spec.layers)
           for t in (l["W"], l["b"])]
    ratios = [float((g - e).abs().max() / max(float((p - e).abs().max()), 1e-30))
              for g, p, e in zip(got, plain, exact)]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    return {"f64_ratio_by_leaf": ratios, "f64_worst_leaf": worst, "f64_worst_ratio": ratios[worst]}


def sweep(args, k3, card) -> dict:
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    lb, ub = (-1.0, 0.0), (1.0, 0.99)
    saved = {}
    for net in args.nets.split(","):
        layers = NETS[net]
        spec = MLPSpec(layers=layers, lb=lb, ub=ub)
        flat = pack_params(init_mlp(spec, torch.Generator().manual_seed(200), "cuda"))
        knob = "NARROW_TILES" if k3.design(layers) == "narrow" else "SPLIT_BLOCKS"
        values = args.narrow_tiles if knob == "NARROW_TILES" else args.split_blocks
        own = args.tree or not values or not hasattr(k3, knob)
        default = getattr(k3, knob, None)
        targets = [default] if own else [
            (int(v),) if knob == "NARROW_TILES" else int(v) for v in values.split(",")]
        for n_f in (int(v) for v in args.n_f.split(",")):
            rng = np.random.default_rng(n_f)
            t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
            colloc = t(rng.uniform(lb, ub, size=(n_f, 2)))
            x_data = t(rng.uniform(lb, ub, size=(args.n_u, 2)))
            u_data = t(rng.standard_normal((args.n_u, 1)))
            z, dual = t(0.1 * rng.standard_normal((n_f, 1))), t(1 + 0.1 * rng.standard_normal((n_f, 1)))
            mu, nu = 0.01 * torch.ones_like(flat), 1e-4 * torch.ones_like(flat)
            for kind in args.kinds.split(","):
                admm = kind == "admm"
                zk, dk = (z, dual) if admm else (None, None)

                def epoch():
                    return k3.fused_adam_step(
                        spec, flat, mu, nu, 4, x_data, u_data, colloc, zk, dk, kind=kind,
                        lam1=1.0, lam2=0.0, rho=10.0, lr=args.lr, explicit_inner=False,
                        seed=9, epoch=5, want_grad=True)

                for target in targets:
                    if not own:
                        setattr(k3, knob, target)
                        k3._cached_plan.cache_clear()
                    try:
                        row = {"net": net, "n_f": n_f, "n_u": args.n_u, "kind": kind,
                               knob.lower(): target, "lr": args.lr,
                               "epoch_ms": event_ms(epoch, args.reps)}
                        if args.profile:
                            row["device_us"], row["kernels"], row["us_by_kernel"] = device_us(epoch)
                        r = epoch()
                        if hasattr(k3, "step_plan"):
                            row["plan"] = dataclasses.asdict(k3.step_plan(layers, n_f, args.n_u))
                        if args.f64:
                            row.update(f64_ratios(k3, spec, flat, r["grad"], x_data, u_data,
                                                  colloc, zk, dk, kind))
                    finally:
                        if not own:
                            setattr(k3, knob, default)
                            k3._cached_plan.cache_clear()
                    if target == default:
                        for key, v in r.items():
                            if v is not None:
                                saved[f"{net}_{n_f}_{kind}_{key}"] = v.cpu().numpy()
                    print(json.dumps({**row, "layers": list(layers), "tree": args.tree or ".",
                                      "card": card, "clock": "cuda_events", "reps": args.reps}),
                          flush=True)
    return saved


def chunks(args, card) -> None:
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    for net in args.nets.split(","):
        preset, dataset = CHUNK_PRESETS[net]
        exp = get_preset(preset)
        assert tuple(exp.model.layers) == NETS[net], (preset, exp.model.layers)
        trainer = tr.Trainer(exp, device="cuda", dataset=dataset)
        state = trainer.init_state(seed=11)
        step = trainer._adam_step
        ms = event_ms(lambda: step(state), args.reps)
        tr.run_chunk(step, state, 10)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.chunk_reps):
            t0 = time.perf_counter()
            tr.run_chunk(step, state, args.chunk)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"net": net, "preset": preset, "epoch_ms": ms, "reps": args.reps,
                          "chunk": args.chunk, "chunk_wall_s": walls,
                          "epochs_per_s": [args.chunk / w for w in walls],
                          "tree": args.tree or ".", "card": card,
                          "clock": "cuda_events (epoch), host (chunks)"}), flush=True)


def compare(a: str, b: str) -> int:
    """Every array two ``--save`` files share: equal bit for bit, and the
    largest difference; 0 when all are equal."""
    with np.load(a) as za, np.load(b) as zb:
        keys = sorted(set(za.files) & set(zb.files))
        rows = {k: (bool(np.array_equal(za[k], zb[k])),
                    float(np.abs(za[k].astype(np.float64) - zb[k]).max())) for k in keys}
    for k, (same, diff) in rows.items():
        print(json.dumps({"key": k, "bit_equal": same, "max_abs_diff": diff}))
    print(json.dumps({"compared": len(rows), "bit_equal": sum(v[0] for v in rows.values())}))
    return 0 if all(v[0] for v in rows.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nets", default="8x20,8x200")
    ap.add_argument("--n-f", default="1000")
    ap.add_argument("--n-u", type=int, default=100)
    ap.add_argument("--kinds", default="admm,l1_sq_norm")
    ap.add_argument("--split-blocks", default=None,
                    help="comma-separated SPLIT_BLOCKS values to time (wide design)")
    ap.add_argument("--narrow-tiles", default=None,
                    help="comma-separated grad-kernel tiles to time (narrow design)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--chunk-reps", type=int, default=3)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("k3_tile_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.ops.kernels import fused_step as k3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if args.chunk:
        chunks(args, card)
        return 0
    saved = sweep(args, k3, card)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        np.savez(args.save, **saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
