"""Write the torch port's Euler fixture from JAX runs on the CPU.

The PyTorch port serves and trains ``euler_admm`` on the GPU, where there is
no jax. This script runs the JAX side once and stores what the port is held
to, in ``tests/fixtures/torch_port/euler_admm.npz``:

- the native ``abgrall_eulers`` grid (``generators.make_abgrall_eulers_grid``,
  float64): its axes ``grid_x`` (300,) and ``grid_t`` (157,), and
  ``grid_idx`` (K, 2) sampled (x, t) indices with the fields there,
  ``grid_rho`` / ``grid_u`` / ``grid_E`` (K,);
- ``euler_admm`` at seed 1234: ``layers``, ``lb``/``ub``, ``gamma``, the
  IC/BC training set ``x_data`` and its targets ``rho_data`` / ``u_data`` /
  ``E_data``; the initial trunk ``params_0`` (flat, W_0, b_0, W_1, ...
  order, as ``interop`` lays the layers out); ``grad_0`` and ``loss_0`` at
  the initial state;
- ``STEPS`` JAX Adam epochs replayed from it: for k = 0..STEPS the
  collocation batch ``colloc_k`` the step k trains on and the ADMM state
  ``z_k`` / ``dual_k`` (3, N_f) before it; ``metrics_k`` (k >= 1) the
  metrics of step k-1 in the port's METRIC_KEYS order; ``params_1`` the
  params after the first step and ``sums_k`` (k >= 1) each leaf's sum and sum
  of squares (float64) after step k-1;
- ``predict_x`` (the full 300 x 157 grid, (47100, 2)) and ``predict_<name>``
  (47100,) for the six served outputs of ``predict_fields`` at ``params_0``;
- the reduced-schedule band: ``band_seeds``, ``band_epochs`` and
  ``band_rel_l2`` (seed, field) with fields (rho, u, E) after
  ``band_epochs`` JAX epochs of ``euler_admm``.

Usage (about six minutes on a CPU, most of it the three band runs):

    JAX_PLATFORMS=cpu python scripts/make_torch_euler_fixture.py [--band-epochs 5000]
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
from pinns_tpu.data import generators  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.evaluate import predict_fields  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

FIXTURE = "tests/fixtures/torch_port/euler_admm.npz"
STEPS = 3
GRID_SAMPLES = 400
BAND_SEEDS = (1234, 7, 99)
FIELDS = ("rho", "u", "E")
SERVED = ("rho", "u", "E", "f1", "f2", "f3")
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(layer[k], np.float32).ravel()
                           for layer in net for k in ("W", "b")])


def leaf_sums(net) -> np.ndarray:
    """(leaves, 2): each leaf's sum and sum of squares, in float64."""
    leaves = [np.asarray(layer[k], np.float64) for layer in net for k in ("W", "b")]
    return np.asarray([(v.sum(), (v * v).sum()) for v in leaves])


def grid_part() -> dict:
    d = generators.make_abgrall_eulers_grid()
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, d["x"].shape[0], GRID_SAMPLES),
                    rng.integers(0, d["t"].shape[0], GRID_SAMPLES)], axis=1)
    out = {"grid_x": d["x"].ravel(), "grid_t": d["t"].ravel(), "grid_idx": idx}
    for name, key in zip(FIELDS, ("rhosol", "usol", "Enersol")):
        out[f"grid_{name}"] = d[key][idx[:, 0], idx[:, 1]]
    return out


def steps_part(exp) -> dict:
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
        "gamma": np.float64(exp.pde.gamma),
        "seed": np.int64(exp.train.seed),
        "x_data": np.asarray(problem.x_data),
        "params_0": flat(state.params["net"]),
        "grad_0": flat(g0["net"]),
        "loss_0": np.float32(loss0),
    }
    for name in FIELDS:
        out[f"{name}_data"] = np.asarray(problem.targets[name])
    ds = problem.dataset
    preds = predict_fields(problem, state.params, ds.X_star)
    out["predict_x"] = ds.X_star
    for name in SERVED:
        out[f"predict_{name}"] = np.asarray(preds[name]).ravel()
    for k in range(STEPS + 1):
        out[f"colloc_{k}"] = np.asarray(state.colloc)
        out[f"z_{k}"] = np.stack([np.asarray(z).ravel() for z in state.admm.z])
        out[f"dual_{k}"] = np.stack([np.asarray(d).ravel() for d in state.admm.dual])
        if k < STEPS:
            state, metrics = step(state)
            out[f"metrics_{k + 1}"] = np.asarray(
                [float(metrics[m]) for m in METRIC_KEYS], np.float32)
            out[f"sums_{k + 1}"] = leaf_sums(state.params["net"])
            if k == 0:
                out["params_1"] = flat(state.params["net"])
    return out


def band_part(exp, band_epochs: int) -> dict:
    rels = []
    for seed in BAND_SEEDS:
        t0 = time.time()
        run = Trainer(override(exp, {"train.epochs": band_epochs, "train.seed": seed,
                                     "train.log_every": 0}))
        _, summary = run.train()
        rels.append([summary[f"rel_l2_{name}"] for name in FIELDS])
        print(f"seed {seed}: rel_l2 {rels[-1]} after {band_epochs} epochs "
              f"({time.time() - t0:.1f} s)", flush=True)
    return {"band_seeds": np.asarray(BAND_SEEDS, np.int64),
            "band_epochs": np.int64(band_epochs),
            "band_rel_l2": np.asarray(rels, np.float64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band-epochs", type=int, default=5_000)
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    exp = get_preset("euler_admm")
    out = {**grid_part(), **steps_part(exp), **band_part(exp, args.band_epochs)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
