"""Write the torch port's shock-path fixture from JAX runs on the CPU.

The PyTorch port trains and serves ``euler_weak`` and ``euler_weak_fast`` on
the GPU, where there is no jax. This script runs the JAX side once and stores
what the port is held to, in ``tests/fixtures/torch_port/euler_weak.npz``:

- ``euler_weak_fast`` at seed 1234: ``layers``, ``lb``/``ub``, ``gamma``,
  ``n_paths``, ``path_degree``, ``path_sharpness``, the training set
  ``x_data``; the initial params ``params_0`` (flat: W_0, b_0, W_1, ... then
  layer 0's ``path_c`` and ``path_a``, the order ``interop.flat_params``
  lays them out), ``coeffs_0`` (raw lambda1, lambda2), ``loss_0``,
  ``grad_0`` and ``gcoeffs_0`` at the initial state;
- ``STEPS`` JAX Adam epochs replayed from it: for k = 0..STEPS the batch
  ``colloc_k`` that step k trains on; ``metrics_k`` (k >= 1) the metrics of
  step k-1 in the port's METRIC_KEYS order, ``coeffs_k`` and ``sums_k``
  (each leaf's sum and sum of squares, float64, path leaves last) after step
  k-1; ``params_1`` the params after the first step;
- the reduced band: ``band_seeds``, ``band_epochs`` and ``band_rel_l2``
  (seed, field) with fields (rho, u, E) after ``band_epochs`` Adam epochs of
  the preset's cosine schedule, uncut;
- ``band_params`` (flat) the first band seed's params at its end, and at
  ``PREDICT_POINTS`` of the 47,100 grid points (``predict_idx`` into the
  grid's flattened ``X_star``, ``predict_x``) the six served outputs of
  ``predict_fields`` at those params, ``predict_<name>``.

Usage (about a quarter of an hour on a CPU, most of it the three band runs):

    JAX_PLATFORMS=cpu python scripts/make_torch_euler_weak_fixture.py [--band-epochs 2000]
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

import numpy as np  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.evaluate import predict_fields  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

FIXTURE = "tests/fixtures/torch_port/euler_weak.npz"
PRESET = "euler_weak_fast"
STEPS = 3
PREDICT_POINTS = 4096
BAND_SEEDS = (1234, 7, 99)
FIELDS = ("rho", "u", "E")
SERVED = ("rho", "u", "E", "f1", "f2", "f3")
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def leaves(net) -> list:
    """The net's leaves in the port's flat order: W, b of every layer, then
    layer 0's path_c and path_a."""
    out = [layer[k] for layer in net for k in ("W", "b")]
    return out + [net[0][k] for k in ("path_c", "path_a") if k in net[0]]


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).ravel() for v in leaves(net)])


def leaf_sums(net) -> np.ndarray:
    """(leaves, 2): each leaf's sum and sum of squares, in float64."""
    vs = [np.asarray(v, np.float64) for v in leaves(net)]
    return np.asarray([(v.sum(), (v * v).sum()) for v in vs])


def coeffs(params) -> np.ndarray:
    return np.asarray([float(params["coeffs"]["lambda1"][0]),
                       float(params["coeffs"]["lambda2"][0])], np.float32)


def steps_part(exp) -> dict:
    trainer = Trainer(exp)
    problem = trainer.problem
    state = trainer.init_state()
    step = jax.jit(make_adam_step(problem, trainer.optimizer))
    loss_fn = make_loss_fn(problem)
    (loss0, _), g0 = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.colloc, state.admm, None)
    m = exp.model
    out = {
        "layers": np.asarray(problem.spec.layers, np.int64),
        "lb": np.asarray(problem.spec.lb, np.float64),
        "ub": np.asarray(problem.spec.ub, np.float64),
        "gamma": np.float64(exp.pde.gamma),
        "n_paths": np.int64(m.n_paths),
        "path_degree": np.int64(m.path_degree),
        "path_sharpness": np.float64(m.path_sharpness),
        "seed": np.int64(exp.train.seed),
        "x_data": np.asarray(problem.x_data),
        "params_0": flat(state.params["net"]),
        "coeffs_0": coeffs(state.params),
        "grad_0": flat(g0["net"]),
        "gcoeffs_0": coeffs(g0),
        "loss_0": np.float32(loss0),
    }
    for k in range(STEPS + 1):
        out[f"colloc_{k}"] = np.asarray(state.colloc)
        if k < STEPS:
            state, metrics = step(state)
            out[f"metrics_{k + 1}"] = np.asarray(
                [float(metrics[name]) for name in METRIC_KEYS], np.float32)
            out[f"sums_{k + 1}"] = leaf_sums(state.params["net"])
            out[f"coeffs_{k + 1}"] = coeffs(state.params)
            if k == 0:
                out["params_1"] = flat(state.params["net"])
    return out


def band_part(exp, band_epochs: int) -> dict:
    rels = []
    out = {}
    for seed in BAND_SEEDS:
        t0 = time.time()
        run = Trainer(override(exp, {"train.epochs": band_epochs, "train.seed": seed,
                                     "train.log_every": 0}))
        state, summary = run.train()
        rels.append([summary[f"rel_l2_{name}"] for name in FIELDS])
        print(f"seed {seed}: rel_l2 {rels[-1]} after {band_epochs} epochs "
              f"({time.time() - t0:.1f} s)", flush=True)
        if seed == BAND_SEEDS[0]:
            problem = run.problem
            x_star = problem.dataset.X_star
            idx = np.sort(np.random.default_rng(0).choice(x_star.shape[0], PREDICT_POINTS,
                                                          replace=False))
            preds = predict_fields(problem, state.params, x_star[idx])
            out["band_params"] = flat(state.params["net"])
            out["predict_idx"] = idx.astype(np.int64)
            out["predict_x"] = np.asarray(x_star[idx], np.float32)
            for name in SERVED:
                out[f"predict_{name}"] = np.asarray(preds[name], np.float32).ravel()
    out.update({"band_seeds": np.asarray(BAND_SEEDS, np.int64),
                "band_epochs": np.int64(band_epochs),
                "band_rel_l2": np.asarray(rels, np.float64)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band-epochs", type=int, default=2_000)
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    exp = get_preset(PRESET)
    out = {**steps_part(exp), **band_part(exp, args.band_epochs)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
