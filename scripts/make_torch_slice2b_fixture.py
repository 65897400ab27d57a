"""Write the torch port's fixture for the rest of slice 2b-iii (Fourier
features, the weak-form ADMM, RAD and SWA) from JAX runs on the CPU.

The PyTorch port trains these on the GPU, where there is no jax. This script
runs the JAX side once and stores what the port is held to, in
``tests/fixtures/torch_port/slice2b_rest.npz`` (``chip_smoke.py``'s phases
43-45 and ``tests/test_torch_rad_swa.py`` read it):

- ``fb_*``: ``burgers_forward --set model.n_fourier=16`` at seed 1234 from
  JAX's own initial state: ``fourier`` (B, (16, 2)), ``layers``, ``lb``,
  ``ub``, ``x_data``, ``colloc_0`` (its fixed batch), ``params_0`` (flat W_0,
  b_0, W_1, ...), ``loss_0``, ``grad_0``; then ``STEPS`` JAX Adam epochs:
  ``metrics_k`` (the port's METRIC_KEYS order) and ``sums_k`` (each leaf's
  sum and sum of squares, float64) after step k-1, ``params_1``;
  ``served_params`` (a net JAX trained for ``SERVED_EPOCHS`` epochs),
  ``served_x`` and JAX's ``served_u``, ``served_f`` there;
- ``fe_*``: ``euler_admm --set model.n_fourier=16`` (the 2x200x5x3 trunk,
  input width 34) at params drawn by :func:`numpy_net` from ``fe_seed`` (the
  port rebuilds them; the trunk's params would not fit here): ``x_data``,
  ``colloc_0``, JAX's ADMM ``z_0``/``dual_0`` (3 fields) there, ``loss_0``,
  ``grad_0``;
- ``fx_*``: ``euler_admm --set loss.admm_form=flux`` at ``numpy_net`` params
  from ``fx_seed``: ``x_data``, ``colloc_k`` (k = 0..STEPS), ``z_k`` and
  ``dual_k`` (the ADMM state on the weak-form cells after step k-1; k = 0
  JAX's init), ``loss_0``, ``grad_0``, ``metrics_k``, ``sums_k``;
- ``rad_<preset>_*`` for ``abgrall_l2`` (8x200, strong form), ``hwan_admm``
  (8x20, ADMM) and ``twosin_weak`` (weak form: scored on the cells) with
  ``sampling.strategy='rad'``: ``seed`` (``numpy_net``'s), ``pool`` (M, 2)
  uniform in the domain and JAX's ``p`` on it (``Trainer._get_rad_resample``'s
  formula, p = |f|^k / (mean |f|^k + 1e-12) + c);
- ``swa_*``: ``SWA_SNAPSHOTS`` snapshots of a small net (``numpy_net`` from
  ``swa_seed + i``) and JAX's SWA mean after each (``Trainer._swa_update``),
  ``mean_i`` flat.

Usage (about a minute on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_slice2b_fixture.py
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
from pinns_tpu.losses.admm import admm_init  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.evaluate import predict_fields  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

FIXTURE = "tests/fixtures/torch_port/slice2b_rest.npz"
STEPS = 3
N_FOURIER = 16
SERVED_EPOCHS = 300
SERVED_POINTS = 2048
RAD_PRESETS = ("abgrall_l2", "hwan_admm", "twosin_weak")
RAD_POOL = 2048
SWA_LAYERS = (2, 8, 8, 1)
SWA_SNAPSHOTS = 4
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def numpy_net(widths, seed: int) -> list:
    """JAX-layout float32 params of these widths from a numpy seed: W with
    the init's scale clipped at 2 sigma, b 0.1 N(0, 1). ``chip_smoke.py``
    rebuilds the same arrays from the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for din, dout in zip(widths[:-1], widths[1:]):
        std = math.sqrt(2.0 / (din + dout))
        out.append({"W": (std * np.clip(rng.standard_normal((din, dout)), -2.0, 2.0))
                    .astype(np.float32),
                    "b": (0.1 * rng.standard_normal((1, dout))).astype(np.float32)})
    return out


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(layer[k], np.float32).ravel()
                           for layer in net for k in ("W", "b")])


def leaf_sums(net) -> np.ndarray:
    vs = [np.asarray(layer[k], np.float64) for layer in net for k in ("W", "b")]
    return np.asarray([(v.sum(), (v * v).sum()) for v in vs])


def jnet(net) -> list:
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def widths(spec) -> tuple:
    return (spec.embed_dim,) + tuple(spec.layers[1:])


def with_params(trainer, state, net):
    """``state`` with params ``net``, a fresh Adam state and, under ADMM, z
    and the dual initialized at its batch (JAX's init semantics)."""
    params = dict(state.params, net=jnet(net))
    admm = state.admm
    if admm is not None:
        admm = admm_init(trainer.problem.training_residuals(params, state.colloc))
    return state._replace(params=params, opt_state=trainer.optimizer.init(params), admm=admm)


def steps(prefix, trainer, state, n_steps, admm=False) -> dict:
    """loss_0 / grad_0 at ``state``, then ``n_steps`` JAX Adam epochs."""
    problem = trainer.problem
    step = jax.jit(make_adam_step(problem, trainer.optimizer))
    (loss0, _), g0 = jax.value_and_grad(make_loss_fn(problem), has_aux=True)(
        state.params, state.colloc, state.admm, None)
    out = {prefix + "loss_0": np.float32(loss0), prefix + "grad_0": flat(g0["net"]),
           prefix + "x_data": np.asarray(problem.x_data)}
    for k in range(n_steps + 1):
        out[f"{prefix}colloc_{k}"] = np.asarray(state.colloc)
        if admm:
            out[f"{prefix}z_{k}"] = np.concatenate([np.asarray(z) for z in state.admm.z], 1)
            out[f"{prefix}dual_{k}"] = np.concatenate([np.asarray(d) for d in state.admm.dual], 1)
        if k < n_steps:
            state, metrics = step(state)
            out[f"{prefix}metrics_{k + 1}"] = np.asarray(
                [float(metrics[m]) for m in METRIC_KEYS], np.float32)
            out[f"{prefix}sums_{k + 1}"] = leaf_sums(state.params["net"])
            if k == 0:
                out[prefix + "params_1"] = flat(state.params["net"])
    return out


def fourier_burgers() -> dict:
    exp = override(get_preset("burgers_forward"), {"model.n_fourier": N_FOURIER})
    trainer = Trainer(exp)
    spec = trainer.problem.spec
    state = trainer.init_state()
    out = {"fb_fourier": np.asarray(spec.fourier, np.float64),
           "fb_layers": np.asarray(spec.layers, np.int64),
           "fb_lb": np.asarray(spec.lb, np.float64), "fb_ub": np.asarray(spec.ub, np.float64),
           "fb_seed": np.int64(exp.train.seed), "fb_params_0": flat(state.params["net"])}
    part = steps("fb_", trainer, state, STEPS)
    # a fixed batch: colloc_1.. equal colloc_0
    out.update({k: v for k, v in part.items() if not k.startswith("fb_colloc_") or
                k == "fb_colloc_0"})
    served = Trainer(override(exp, {"train.epochs": SERVED_EPOCHS, "train.log_every": 0}))
    trained, _ = served.train()
    x = np.random.default_rng(5).uniform(spec.lb, spec.ub, (SERVED_POINTS, 2)).astype(np.float32)
    pred = predict_fields(served.problem, trained.params, jnp.asarray(x))
    out.update({"fb_served_params": flat(trained.params["net"]), "fb_served_x": x,
                "fb_served_u": np.asarray(pred["u"]), "fb_served_f": np.asarray(pred["f"]),
                "fb_served_lambda": np.asarray(
                    [float(trained.params["coeffs"][c][0]) for c in ("lambda1", "lambda2")],
                    np.float32)})
    return out


def euler_part(prefix: str, updates: dict, seed: int, n_steps: int) -> dict:
    exp = override(get_preset("euler_admm"), updates)
    trainer = Trainer(exp)
    spec = trainer.problem.spec
    state = with_params(trainer, trainer.init_state(), numpy_net(widths(spec), seed))
    out = {prefix + "seed": np.int64(seed), prefix + "layers": np.asarray(spec.layers, np.int64),
           prefix + "lb": np.asarray(spec.lb, np.float64),
           prefix + "ub": np.asarray(spec.ub, np.float64)}
    out.update(steps(prefix, trainer, state, n_steps, admm=True))
    return out


def rad_part(preset: str, seed: int) -> dict:
    exp = override(get_preset(preset), {"sampling.strategy": "rad"})
    trainer = Trainer(exp)
    problem = trainer.problem
    spec = problem.spec
    params = dict(trainer.init_state().params, net=jnet(numpy_net(widths(spec), seed)))
    pool = np.random.default_rng(seed + 1).uniform(spec.lb, spec.ub, (RAD_POOL, 2)) \
        .astype(np.float32)
    cfg = exp.sampling
    if exp.loss.residual_kind == "flux" or problem.admm_flux:
        f = problem.flux_residuals_and_entropy(params, jnp.asarray(pool), False)[0]
    else:
        f = problem.residuals(params, jnp.asarray(pool))
    fs = f if isinstance(f, tuple) else (f,)
    score = sum(jnp.abs(fi[:, 0]) for fi in fs)
    pk = score ** cfg.rad_k
    p = pk / (jnp.mean(pk) + 1e-12) + cfg.rad_c
    p_ = f"rad_{preset}_"
    return {p_ + "seed": np.int64(seed), p_ + "pool": pool, p_ + "p": np.asarray(p)}


def swa_part(seed: int) -> dict:
    trainer = Trainer(get_preset("abgrall_admm"))
    avg, n = None, 0
    out = {"swa_seed": np.int64(seed), "swa_layers": np.asarray(SWA_LAYERS, np.int64)}
    for i in range(SWA_SNAPSHOTS):
        avg, n = trainer._swa_update(avg, n, {"net": jnet(numpy_net(SWA_LAYERS, seed + i))})
        out[f"swa_mean_{i}"] = flat(avg["net"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    out = fourier_burgers()
    out.update(euler_part("fe_", {"model.n_fourier": N_FOURIER}, 501, 0))
    out.update(euler_part("fx_", {"loss.admm_form": "flux"}, 502, STEPS))
    for i, preset in enumerate(RAD_PRESETS):
        out.update(rad_part(preset, 600 + 10 * i))
    out.update(swa_part(700))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
