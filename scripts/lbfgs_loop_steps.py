"""K10's solve as one launch of its WHILE-node graph at k = 1, 4 and 16
evaluation steps a body iteration, for each solver the port runs, on the
card: the numbers ``ops/kernels/lbfgs.py``'s DEVICE_STEPS and AUTOGRAD_STEPS
are chosen from.

    python scripts/lbfgs_loop_steps.py [--solvers device,euler_tail,polish,inverse]
        [--ks 1,4,16] [--turns 3] [--out FILE]

The solvers and their solves:
- ``device``: DeviceLBFGS (K3's value-and-grad) from the committed JAX
  fixture's abgrall_admm state, a 200-iteration solve (chip_smoke.py's
  phase 37);
- ``euler_tail``: AutogradLBFGS over euler_weak_tail's loss from the tail
  fixture's state, a 50-iteration outer epoch (phase 39);
- ``polish``: AutogradLBFGS in float64 over burgers_forward's loss from the
  committed JAX state, 200 iterations (phase 46);
- ``inverse``: AutogradLBFGS over burgers_inverse's loss after 500 Adam
  epochs, a 300-iteration outer epoch (phase 49).

For each k, in turns: the solve's wall ms (host clock, ending in a
synchronize; an autograd solve's capture, which it makes anew, is
reported apart and taken off), ms an iteration, the steps run and the
steps after the end (the solver's counters), then one solve under
torch.profiler: its device time and launches an iteration. Every solve at
every k must end at the same iterate (bit for bit). Prints one JSON line a
solver, with the card's name and power limit. Needs one NVIDIA GPU; imports
no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device(k: int):
    import chip_smoke as cs
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree

    problem, params, colloc, admm, _, _ = cs.replay_state()
    cfg = problem.exp.optimizer.lbfgs
    x0, _ = ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    solver = k_lbfgs.DeviceLBFGS(problem, steps=k)
    return solver, lambda: solver.minimize(x0, off, colloc, admm, problem.exp.loss.rho,
                                           max_iters=cs.LONG_SOLVE, history=cfg.history,
                                           ftol=cfg.ftol, gtol=cfg.gtol, max_ls=cfg.max_ls)


def _autograd(k: int, fun, x0, max_iters: int, **opts):
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    solver = k_lbfgs.AutogradLBFGS(steps=k)
    return solver, lambda: solver.minimize(fun, x0, max_iters=max_iters, **opts)


def _euler_tail(k: int):
    import chip_smoke as cs
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.train import trainer as tr

    exp = get_preset(cs.TAIL_PRESET)
    cfg = exp.optimizer.lbfgs
    problem = tr.build_problem(exp, "cuda")
    params, colloc, _ = cs.tail_state(problem)
    x0, unravel = ravel_tree(params)
    loss_fn = tr.make_loss_fn(problem)
    return _autograd(k, lambda x: loss_fn(unravel(x), colloc, None)[0], x0,
                     cs.TAIL_TIMED_ITERS, history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol,
                     max_ls=cfg.max_ls)


def _polish(k: int):
    import chip_smoke as cs
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.interop import load_params_npz
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.train import trainer as tr
    from pinns_tpu_torch.train.polish import FTOL, GTOL

    exp = override(get_preset("burgers_forward"), {"model.dtype": "float64"})
    problem = tr.build_problem(exp, "cuda")
    loaded = load_params_npz(cs.FIXTURE)
    net = [{n: torch.as_tensor(np.asarray(v), dtype=torch.float64).cuda().contiguous()
            for n, v in layer.items()} for layer in loaded["params"]]
    params = {"net": net, "coeffs": {
        name: torch.full((1,), v, dtype=torch.float64, device="cuda")
        for name, v in (("lambda1", exp.pde.lambda1), ("lambda2", exp.pde.lambda2))}}
    colloc = tr.init_collocation(problem, exp.train.seed)
    x0, unravel = ravel_tree(params)
    loss_fn = tr.make_loss_fn(problem)
    return _autograd(k, lambda x: loss_fn(unravel(x), colloc, None)[0], x0, cs.POLISH_ITERS,
                     history=exp.optimizer.lbfgs.history, ftol=FTOL, gtol=GTOL)


_INVERSE = {}


def _inverse(k: int):
    import chip_smoke as cs
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.train import trainer as tr

    if not _INVERSE:  # one Adam state for every k
        exp = override(get_preset("burgers_inverse"), {"train.log_every": 0})
        trainer = tr.Trainer(exp, device="cuda")
        state, _ = trainer.train(epochs=cs.INVERSE_ADAM)
        _INVERSE.update(problem=trainer.problem, state=state)
    problem, state = _INVERSE["problem"], _INVERSE["state"]
    cfg = problem.exp.optimizer.lbfgs
    x0, unravel = ravel_tree(state.params)
    loss_fn = tr.make_loss_fn(problem)
    return _autograd(k, lambda x: loss_fn(unravel(x), state.colloc, state.admm, state.rho)[0],
                     x0.detach(), cs.INVERSE_MAX_ITERS, history=cfg.history, ftol=cfg.ftol,
                     gtol=cfg.gtol, max_ls=cfg.max_ls)


SOLVERS = {"device": _device, "euler_tail": _euler_tail, "polish": _polish, "inverse": _inverse}


def _profile(fn) -> tuple:
    """(device us, kernel launches) of one call of ``fn`` by torch.profiler
    (None where it records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            us += t
            if not evt.key.startswith(("Memcpy", "Memset")):
                launches += evt.count
    return (us, launches) if us > 0 else (None, None)


def sweep(name: str, ks, turns: int) -> dict:
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    runs = {k: SOLVERS[name](k) for k in ks}
    first = {k: fn() for k, (_, fn) in runs.items()}  # captures, set-ups
    ref = first[ks[0]]
    for k, res in first.items():
        if not (torch.equal(res.x, ref.x) and (res.n_iters, res.n_evals) ==
                (ref.n_iters, ref.n_evals)):
            raise RuntimeError(f"{name}: the solve at k {k} differs from k {ks[0]}")
    walls = {k: [] for k in ks}
    capture = {k: [] for k in ks}
    counts = {}
    for _ in range(turns):
        for k, (solver, fn) in runs.items():
            before = (k_lbfgs.LOOP_STEPS, k_lbfgs.STEPS_AFTER_END, host_lbfgs.HOST_SYNCS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append(1e3 * (time.perf_counter() - t0))
            if isinstance(solver, k_lbfgs.AutogradLBFGS):
                capture[k].append(1e3 * solver.capture_seconds[-1])
            counts[k] = [a - b for a, b in zip((k_lbfgs.LOOP_STEPS, k_lbfgs.STEPS_AFTER_END,
                                                host_lbfgs.HOST_SYNCS), before)]
    it = max(1, ref.n_iters)
    rows = {}
    for k, (solver, fn) in runs.items():
        wall = statistics.median(walls[k])
        cap = statistics.median(capture[k]) if capture[k] else 0.0
        us, launches = _profile(fn)
        rows[str(k)] = {
            "wall_ms": walls[k], "capture_ms": capture[k], "solve_ms": wall - cap,
            "ms_per_iter": (wall - cap) / it, "steps": counts[k][0],
            "steps_after_end": counts[k][1], "host_syncs": counts[k][2],
            "device_us_per_iter": None if us is None else us / it,
            "launches_per_iter": None if launches is None else launches / it,
            "idle_share": None if us is None else 1.0 - 1e-3 * us / (wall - cap)}
    return {"solver": name, "n_iters": ref.n_iters, "n_evals": ref.n_evals, "by_k": rows,
            "bit_equal_across_k": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solvers", default=",".join(SOLVERS))
    ap.add_argument("--ks", default="1,4,16")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lbfgs_loop_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    ks = [int(v) for v in args.ks.split(",")]
    out = []
    for name in args.solvers.split(","):
        row = {"card": card, **sweep(name, ks, args.turns)}
        print(json.dumps(row), flush=True)
        out.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
