"""Train a small JAX Burgers model on the CPU and write the torch port's fixture.

The PyTorch port (``pinns_tpu_torch``) is held against the JAX package, but
the machine that runs the port on a GPU has no jax. This script runs the JAX
side once and stores what the port must reproduce:

  params in the port's params-file format (``pinns_tpu_torch.interop``),
  ``X_star`` (the 25,600 grid points, float32, as JAX was fed them),
  ``u_star`` (the exact Cole-Hopf solution),
  ``u_jax`` / ``f_jax`` (JAX ``predict_fields`` at X_star),
  ``rel_l2_jax`` (JAX's relative L2 error of u against u_star).

Usage (about a minute on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py \
        [--epochs 3000] [--out tests/fixtures/torch_port/burgers_forward_8x20.npz]

The preset is ``burgers_forward`` (2 -> 20x8 -> 1, lambda2 = 0.01/pi) with its
own seed (TrainConfig.seed = 1234); only the epoch count is cut.
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.evaluate import predict_fields, relative_l2  # noqa: E402
from pinns_tpu_torch.interop import save_params_npz  # noqa: E402
from pinns_tpu_torch.models.mlp import MLPSpec  # noqa: E402

DEFAULT_OUT = "tests/fixtures/torch_port/burgers_forward_8x20.npz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    exp = override(get_preset("burgers_forward"), {"train.epochs": args.epochs})
    trainer = Trainer(exp)
    state, summary = trainer.train()
    problem = trainer.problem
    ds = problem.dataset

    x_star = np.asarray(ds.X_star, np.float32)
    preds = predict_fields(problem, state.params, jnp.asarray(x_star))
    u_jax = np.asarray(preds["u"], np.float32)
    f_jax = np.asarray(preds["f"], np.float32)
    u_star = np.asarray(ds.star["u"])
    rel = relative_l2(u_jax, u_star)
    lam1, lam2 = problem.effective_coeffs(state.params)

    jspec = problem.spec
    spec = MLPSpec(layers=jspec.layers, lb=jspec.lb, ub=jspec.ub)
    params = [
        {"W": np.asarray(layer["W"]), "b": np.asarray(layer["b"])}
        for layer in state.params["net"]
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_params_npz(
        args.out, spec, params,
        lambda1=float(np.asarray(lam1).reshape(())),
        lambda2=float(np.asarray(lam2).reshape(())),
        experiment=exp.name,
        X_star=x_star, u_star=u_star, u_jax=u_jax, f_jax=f_jax,
        rel_l2_jax=np.asarray(rel, np.float64),
        epochs=np.asarray(args.epochs, np.int64),
        seed=np.asarray(exp.train.seed, np.int64),
    )
    print(f"wrote {args.out}: epochs={args.epochs} seed={exp.train.seed} "
          f"rel_l2_u={rel:.6e} (trainer summary {summary.get('rel_l2_u')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
