"""Write the torch port's scale-slice fixture from JAX runs on the CPU.

The port trains ``burgers_scale`` on the GPU, where there is no jax. This
script runs the JAX side once, at the preset's full width (8x200) and with
``sampling.n_f`` = 16,384 in ``microbatch`` = 2 chunks, so that each chunk
holds the preset's 8,192 points:

``tests/fixtures/torch_port/burgers_scale_steps.npz``
    ``seed``, ``layers``, ``lb``/``ub``, ``n_f``, ``microbatch``, ``steps``;
    ``x_data``/``u_data`` (the N_u set); ``params_sum`` and ``colloc_sum``
    (float64 sums of what :func:`draw` makes, so a reader can check that it
    rebuilt the same arrays); for each policy P in ``POLICIES`` (f32, keep_xx,
    max): ``P_loss``, ``P_data_term``, ``P_res_term`` (one per Adam step, at
    the params before it, each step fed the next drawn batch) and
    ``P_grad_norms`` (the L2 norm of each leaf of the step-0 gradient, W_0,
    b_0, W_1, ... order); and ``f32_grad_0``, the whole step-0 float32
    gradient (flat, the same order).

The params and the batches are not stored: :func:`draw` makes them with numpy
from ``seed``, and the port rebuilds them the same way (``chip_smoke.py``,
``tests/test_torch_microbatch.py``).

Usage (about 2 minutes on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_scale_fixture.py
"""

from __future__ import annotations

import argparse
import math
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
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

OUT = "tests/fixtures/torch_port/burgers_scale_steps.npz"
SEED = 2024
N_F = 16_384
MICROBATCH = 2
STEPS = 3
POLICIES = {
    "f32": {},
    "keep_xx": {"model.compute_dtype": "bfloat16", "model.keep_streams": ("xx",)},
    "max": {"model.compute_dtype": "bfloat16", "model.mixed_elementwise": True},
}


def draw(seed: int, layers, lb, ub, n_f: int, steps: int):
    """(params, batches): JAX-layout float32 params (W truncated at 2 sigma,
    sigma = sqrt(2 / (din + dout)), b = 0) and ``steps`` uniform batches of
    (n_f, 2) float32 points in [lb, ub), all from one numpy generator."""
    rng = np.random.default_rng(seed)
    params = []
    for din, dout in zip(layers[:-1], layers[1:]):
        std = math.sqrt(2.0 / (din + dout))
        w = std * np.clip(rng.standard_normal((din, dout)), -2.0, 2.0)
        params.append({"W": w.astype(np.float32), "b": np.zeros((1, dout), np.float32)})
    batches = [rng.uniform(lb, ub, size=(n_f, 2)).astype(np.float32) for _ in range(steps)]
    return params, batches


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(layer[k], np.float32).ravel()
                           for layer in net for k in ("W", "b")])


def run_policy(updates: dict, params_np, batches):
    """JAX's metrics over len(batches) Adam steps and its step-0 gradient."""
    exp = override(get_preset("burgers_scale"), {
        "sampling.n_f": N_F, "sampling.microbatch": MICROBATCH, **updates})
    trainer = Trainer(exp)
    problem = trainer.problem
    params = {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params_np],
              "coeffs": {"lambda1": jnp.full((1,), exp.pde.lambda1, jnp.float32),
                         "lambda2": jnp.full((1,), exp.pde.lambda2, jnp.float32)}}
    state = trainer.init_state()._replace(params=params,
                                          opt_state=trainer.optimizer.init(params))
    grad0 = jax.grad(lambda p: make_loss_fn(problem)(p, jnp.asarray(batches[0]), None)[0])(
        params)["net"]
    step = jax.jit(make_adam_step(problem, trainer.optimizer))
    rows = {"loss": [], "data_term": [], "res_term": []}
    for pts in batches:
        state, metrics = step(state._replace(colloc=jnp.asarray(pts)))
        for k in rows:
            rows[k].append(float(metrics[k]))
        print(f"  {updates or 'f32'}: loss {rows['loss'][-1]:.9g}", flush=True)
    return problem, rows, flat(grad0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    base = Trainer(override(get_preset("burgers_scale"), {
        "sampling.n_f": N_F, "sampling.microbatch": MICROBATCH})).problem
    layers, lb, ub = base.spec.layers, base.spec.lb, base.spec.ub
    params, batches = draw(SEED, layers, lb, ub, N_F, STEPS)
    out = {
        "seed": np.int64(SEED), "layers": np.asarray(layers, np.int64),
        "lb": np.asarray(lb, np.float64), "ub": np.asarray(ub, np.float64),
        "n_f": np.int64(N_F), "microbatch": np.int64(MICROBATCH), "steps": np.int64(STEPS),
        "x_data": np.asarray(base.x_data), "u_data": np.asarray(base.targets["u"]),
        "params_sum": np.float64(flat(params).astype(np.float64).sum()),
        "colloc_sum": np.float64(sum(b.astype(np.float64).sum() for b in batches)),
    }
    for name, updates in POLICIES.items():
        _, rows, grad0 = run_policy(updates, params, batches)
        for k, v in rows.items():
            out[f"{name}_{k}"] = np.asarray(v, np.float64)
        leaves = np.split(grad0, np.cumsum([a.size for layer in params
                                            for a in (layer["W"], layer["b"])])[:-1])
        out[f"{name}_grad_norms"] = np.asarray([np.linalg.norm(g.astype(np.float64))
                                                for g in leaves])
        if name == "f32":
            out["f32_grad_0"] = grad0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
