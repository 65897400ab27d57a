"""Write the torch port's training fixtures from JAX runs on the CPU.

The PyTorch port trains ``abgrall_admm`` on the GPU, where there is no jax.
This script runs the JAX side once and stores what the port is held to:

``tests/fixtures/torch_port/twosin_burgers_shock.npz``
    the TwoSin grid (513 x 101) as the JAX package regenerates it
    (``generators.make_twosin_grid``): ``x`` (Nx, 1), ``t`` (Nt, 1),
    ``usol`` (Nx, Nt), float32 as ``GridDataset`` holds them, and
    ``provenance`` 'native'. The port's dataset loader reads it.

``tests/fixtures/torch_port/abgrall_admm_steps.npz``
    ``abgrall_admm`` (seed 1234) replayed for ``STEPS`` JAX Adam epochs:
    ``layers``, ``lb``/``ub``, ``lambda1``/``lambda2``, ``x_data``/``u_data``;
    for k = 0..STEPS the state before step k: ``params_k`` / ``mu_k`` /
    ``nu_k`` (flat, W_0, b_0, W_1, ... order), ``count_k``, ``colloc_k``,
    ``z_k``, ``dual_k``; ``metrics_k`` (k >= 1) the metrics of step k-1 in
    the port's METRIC_KEYS order; ``grad_0``, ``loss_0`` the gradient and
    loss at the initial state; and the rel-L2 band: ``band_seeds``,
    ``band_rel_l2`` (u after ``band_epochs`` JAX epochs, one per seed).

Usage (about three minutes on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_train_fixture.py [--band-epochs 10000]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.data import generators  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

FIXDIR = "tests/fixtures/torch_port"
STEPS = 5
BAND_SEEDS = (1234, 7, 99)
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(layer[k], np.float32).ravel()
                           for layer in net for k in ("W", "b")])


def write_grid(path: str) -> None:
    d = generators.make_twosin_grid()
    np.savez_compressed(
        path, x=np.asarray(d["x"], np.float32), t=np.asarray(d["t"], np.float32),
        usol=np.asarray(d["usol"], np.float32), provenance=np.asarray("native"),
    )


def write_steps(path: str, band_epochs: int) -> None:
    exp = get_preset("abgrall_admm")
    trainer = Trainer(exp)
    problem = trainer.problem
    state = trainer.init_state()
    step = jax.jit(make_adam_step(problem, trainer.optimizer))
    loss_fn = make_loss_fn(problem)
    (loss0, _), g0 = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.colloc, state.admm, None)
    out = {
        "layers": np.asarray(problem.spec.layers, np.int64),
        "lb": np.asarray(problem.spec.lb, np.float64),
        "ub": np.asarray(problem.spec.ub, np.float64),
        "lambda1": np.float32(exp.pde.lambda1), "lambda2": np.float32(exp.pde.lambda2),
        "x_data": np.asarray(problem.x_data), "u_data": np.asarray(problem.targets["u"]),
        "grad_0": flat(g0["net"]), "loss_0": np.float32(loss0),
        "seed": np.int64(exp.train.seed),
    }
    for k in range(STEPS + 1):
        adam = state.opt_state[0]
        out.update({
            f"params_{k}": flat(state.params["net"]), f"mu_{k}": flat(adam.mu["net"]),
            f"nu_{k}": flat(adam.nu["net"]), f"count_{k}": np.int64(adam.count),
            f"colloc_{k}": np.asarray(state.colloc), f"z_{k}": np.asarray(state.admm.z),
            f"dual_{k}": np.asarray(state.admm.dual),
        })
        if k < STEPS:
            state, metrics = step(state)
            out[f"metrics_{k + 1}"] = np.asarray(
                [float(metrics[m]) for m in METRIC_KEYS], np.float32)
    rels = []
    for seed in BAND_SEEDS:
        run = Trainer(override(exp, {"train.epochs": band_epochs, "train.seed": seed,
                                     "train.log_every": 0}))
        _, summary = run.train()
        rels.append(summary["rel_l2_u"])
        print(f"seed {seed}: rel_l2_u {summary['rel_l2_u']:.6f} after {band_epochs} epochs")
    out.update(band_seeds=np.asarray(BAND_SEEDS, np.int64),
               band_rel_l2=np.asarray(rels, np.float64),
               band_epochs=np.int64(band_epochs))
    np.savez_compressed(path, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band-epochs", type=int, default=10_000)
    ap.add_argument("--out-dir", default=FIXDIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    grid = os.path.join(args.out_dir, "twosin_burgers_shock.npz")
    write_grid(grid)
    steps = os.path.join(args.out_dir, "abgrall_admm_steps.npz")
    write_steps(steps, args.band_epochs)
    for p in (grid, steps):
        print(f"wrote {p} ({os.path.getsize(p)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
