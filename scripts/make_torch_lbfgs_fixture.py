"""Write the torch port's L-BFGS fixtures from JAX runs on the CPU.

The port runs the L-BFGS phase of the hybrid schedule on the GPU, where there
is no jax. This script runs the JAX side once and stores what the port is
held to:

``tests/fixtures/torch_port/burgers_shock.npz``
    the 256 x 100 Cole-Hopf grid of ``burgers_forward`` as the JAX package
    regenerates it (``generators.make_burgers_shock_grid``): ``x`` (Nx, 1),
    ``t`` (Nt, 1), ``usol`` (Nx, Nt), float32, ``provenance`` 'native'.

``tests/fixtures/torch_port/lbfgs_hybrid.npz``
    * the L-BFGS replay: JAX's ``lbfgs_minimize`` (float32, the preset's
      ``LBFGSConfig``) on the ``abgrall_admm`` loss at the state of
      ``abgrall_admm_steps.npz`` after 5 Adam steps (``params_5``,
      ``colloc_5``, ``z_5``, ``dual_5``; lambda1 = 1, lambda2 = 0), for
      ``replay_iters`` = (1, 2, 5, 200): ``x0`` and ``f0``, then per k
      ``x_k`` (ravel_pytree order: lambda1, lambda2, W_0, b_0, ...),
      ``f_k``, ``n_iters_k``, ``n_evals_k``, ``converged_k``;
    * the band of hybrid ``abgrall_admm``: u rel-L2 of three seeds
      (``band_seeds``) after ``hybrid_adam`` Adam epochs and
      ``hybrid_outer`` L-BFGS outer epochs of at most ``hybrid_max_iters``
      iterations (``hybrid_rel_l2``);
    * the band of ``burgers_forward`` at a reduced schedule: ``bf_adam`` Adam
      epochs of cosine decay over ``bf_schedule`` epochs, then ``bf_outer``
      L-BFGS outer epochs of at most ``bf_max_iters`` iterations
      (``bf_rel_l2``, the same seeds).

Usage (four to six minutes on a CPU, most of it in the three-seed bands):

    JAX_PLATFORMS=cpu python scripts/make_torch_lbfgs_fixture.py
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.data import generators  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.losses.admm import ADMMState  # noqa: E402
from pinns_tpu.opt.lbfgs import lbfgs_minimize  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.trainer import build_problem, make_loss_fn  # noqa: E402

FIXDIR = "tests/fixtures/torch_port"
REPLAY_ITERS = (1, 2, 5, 200)
REPLAY_STEP = 5  # the state of abgrall_admm_steps.npz the replay starts from
BAND_SEEDS = (1234, 7, 99)
HYBRID = {"adam": 10_000, "outer": 10, "max_iters": 300}
BURGERS = {"adam": 3000, "schedule": 2700, "outer": 1, "max_iters": 1000}


def write_grid(path: str) -> None:
    d = generators.make_burgers_shock_grid(nx=256, nt=100)
    np.savez_compressed(
        path, x=np.asarray(d["x"], np.float32), t=np.asarray(d["t"], np.float32),
        usol=np.asarray(d["usol"], np.float32), provenance=np.asarray("native"),
    )


def unflatten(flat: np.ndarray, layers) -> list:
    out, off = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        w = flat[off:off + din * dout].reshape(din, dout)
        off += din * dout
        out.append({"W": jnp.asarray(w), "b": jnp.asarray(flat[off:off + dout].reshape(1, dout))})
        off += dout
    return out


def replay(steps_path: str) -> dict:
    with np.load(steps_path) as z:
        fx = {k: z[k] for k in z.files}
    exp = get_preset("abgrall_admm")
    problem = build_problem(exp)
    assert np.array_equal(np.asarray(problem.x_data), fx["x_data"]), "N_u set moved"
    k = REPLAY_STEP
    params = {"net": unflatten(fx[f"params_{k}"], tuple(int(w) for w in fx["layers"])),
              "coeffs": {"lambda1": jnp.full((1,), fx["lambda1"], jnp.float32),
                         "lambda2": jnp.full((1,), fx["lambda2"], jnp.float32)}}
    colloc = jnp.asarray(fx[f"colloc_{k}"])
    admm = ADMMState(z=jnp.asarray(fx[f"z_{k}"]), dual=jnp.asarray(fx[f"dual_{k}"]))
    loss_fn = make_loss_fn(problem)
    x0, unravel = ravel_pytree(params)
    fun = lambda x: loss_fn(unravel(x), colloc, admm, None)[0]  # noqa: E731
    cfg = exp.optimizer.lbfgs
    out = {"replay_step": np.int64(k), "replay_iters": np.asarray(REPLAY_ITERS, np.int64),
           "x0": np.asarray(x0), "f0": np.float32(jax.jit(fun)(x0))}
    for iters in REPLAY_ITERS:
        solve = jax.jit(lambda x, iters=iters: lbfgs_minimize(
            fun, x, max_iters=iters, history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol,
            max_ls=cfg.max_ls))
        res = solve(x0)
        out.update({f"x_{iters}": np.asarray(res.x), f"f_{iters}": np.float32(res.f),
                    f"n_iters_{iters}": np.int64(res.n_iters),
                    f"n_evals_{iters}": np.int64(res.n_evals),
                    f"converged_{iters}": np.bool_(res.converged)})
        print(f"replay k={iters}: f {float(res.f):.9g} n_iters {int(res.n_iters)} "
              f"n_evals {int(res.n_evals)} converged {bool(res.converged)}", flush=True)
    return out


def band(preset: str, updates: dict) -> np.ndarray:
    rels = []
    for seed in BAND_SEEDS:
        t0 = time.time()
        exp = override(get_preset(preset), dict(updates, **{"train.seed": seed,
                                                             "train.log_every": 0}))
        _, summary = Trainer(exp).train()
        rels.append(summary["rel_l2_u"])
        print(f"{preset} seed {seed}: rel_l2_u {summary['rel_l2_u']:.6f} "
              f"({time.time() - t0:.0f} s)", flush=True)
    return np.asarray(rels, np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=FIXDIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    grid = os.path.join(args.out_dir, "burgers_shock.npz")
    write_grid(grid)
    out = replay(os.path.join(args.out_dir, "abgrall_admm_steps.npz"))
    out.update(
        band_seeds=np.asarray(BAND_SEEDS, np.int64),
        hybrid_adam=np.int64(HYBRID["adam"]), hybrid_outer=np.int64(HYBRID["outer"]),
        hybrid_max_iters=np.int64(HYBRID["max_iters"]),
        hybrid_rel_l2=band("abgrall_admm", {
            "train.epochs": HYBRID["adam"] + HYBRID["outer"],
            "optimizer.switch_epoch": HYBRID["adam"],
            "optimizer.lbfgs.max_iters": HYBRID["max_iters"]}),
        bf_adam=np.int64(BURGERS["adam"]), bf_schedule=np.int64(BURGERS["schedule"]),
        bf_outer=np.int64(BURGERS["outer"]), bf_max_iters=np.int64(BURGERS["max_iters"]),
        bf_rel_l2=band("burgers_forward", {
            "train.epochs": BURGERS["adam"] + BURGERS["outer"],
            "optimizer.switch_epoch": BURGERS["adam"],
            "optimizer.schedule_epochs": BURGERS["schedule"],
            "optimizer.lbfgs.max_iters": BURGERS["max_iters"]}),
    )
    path = os.path.join(args.out_dir, "lbfgs_hybrid.npz")
    np.savez_compressed(path, **out)
    for p in (grid, path):
        print(f"wrote {p} ({os.path.getsize(p)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
