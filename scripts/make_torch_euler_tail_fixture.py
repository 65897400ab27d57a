"""Write the torch port's Euler L-BFGS fixture from JAX runs on the CPU.

The PyTorch port runs ``euler_weak_tail``'s L-BFGS outer epochs on the GPU
(K10 around autograd through the Euler path loss), where there is no jax.
This script runs the JAX side once and stores what the port is held to, in
``tests/fixtures/torch_port/euler_weak_tail.npz``:

- the start: ``euler_weak.npz``'s ``band_params`` (read from that fixture,
  not stored again; the flat order of ``interop.flat_params``) with the
  preset's coefficients ``coeffs`` (raw lambda1, lambda2), and ``colloc``, a
  batch JAX draws with ``_resample`` at the curriculum's full bounds
  (``epoch``, past ``t_curriculum_epochs``) from ``PRNGKey(batch_seed)``;
- for k in ``ITERS``: JAX's float32 solve of the loss at that state with
  ``optimizer.lbfgs.max_iters`` = k: ``f_k`` (its final loss),
  ``n_iters_k``, ``n_evals_k`` and ``sums_k`` (each leaf's sum and sum of
  squares after it, float64, the port's flat leaf order: W, b of every
  layer, then layer 0's path_c and path_a); and ``metrics_k``, the metrics
  of JAX's outer epoch (``make_lbfgs_step``) from the same state in the
  port's METRIC_KEYS order. (XLA compiles the solve inside the step into
  another program than the solve alone, so their float32 iterates differ in
  the last bits; the script checks that they take the same iterations.)

Usage (a few minutes on a CPU, most of it three compiles of the solve):

    JAX_PLATFORMS=cpu python scripts/make_torch_euler_tail_fixture.py
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
from jax.flatten_util import ravel_pytree  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.opt.lbfgs import lbfgs_minimize  # noqa: E402
from pinns_tpu.train.trainer import (  # noqa: E402
    TrainState,
    _resample,
    build_problem,
    make_lbfgs_step,
    make_loss_fn,
)

FIXTURE = "tests/fixtures/torch_port/euler_weak_tail.npz"
SOURCE = "tests/fixtures/torch_port/euler_weak.npz"
PRESET = "euler_weak_tail"
ITERS = (1, 2, 5)
BATCH_SEED = 2026
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def unflat(flat: np.ndarray, layers, n_paths: int, degree: int) -> list:
    """JAX-layout params of a path net from the port's flat order."""
    widths = (2 + n_paths,) + tuple(layers[1:])
    out, off = [], 0
    for din, dout in zip(widths[:-1], widths[1:]):
        w = flat[off:off + din * dout].reshape(din, dout)
        off += din * dout
        b = flat[off:off + dout].reshape(1, dout)
        off += dout
        out.append({"W": jnp.asarray(w), "b": jnp.asarray(b)})
    c = flat[off:off + n_paths * (degree + 1)].reshape(n_paths, degree + 1)
    off += n_paths * (degree + 1)
    out[0]["path_c"] = jnp.asarray(c)
    out[0]["path_a"] = jnp.asarray(flat[off:off + n_paths])
    off += n_paths
    if off != flat.size:
        raise ValueError(f"flat params of {flat.size} entries, the net takes {off}")
    return out


def leaf_sums(net) -> np.ndarray:
    """(leaves, 2): each leaf's sum and sum of squares, in float64."""
    leaves = [layer[k] for layer in net for k in ("W", "b")]
    leaves += [net[0][k] for k in ("path_c", "path_a")]
    vs = [np.asarray(v, np.float64) for v in leaves]
    return np.asarray([(v.sum(), (v * v).sum()) for v in vs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    exp = get_preset(PRESET)
    problem = build_problem(exp)
    m = exp.model
    with np.load(SOURCE) as z:
        band = z["band_params"]
        if tuple(z["layers"]) != tuple(m.layers):
            raise ValueError(f"{SOURCE} holds widths {tuple(z['layers'])}, not {m.layers}")
    net = unflat(band, m.layers, m.n_paths, m.path_degree)
    coeffs = np.asarray([exp.pde.lambda1, exp.pde.lambda2], np.float32)
    params = {"net": net, "coeffs": {"lambda1": jnp.asarray(coeffs[0:1]),
                                     "lambda2": jnp.asarray(coeffs[1:2])}}
    epoch = exp.optimizer.switch_epoch
    if epoch + 1 < exp.sampling.t_curriculum_epochs:
        raise ValueError("the L-BFGS phase starts inside the time curriculum")
    colloc = _resample(problem, jax.random.PRNGKey(BATCH_SEED), epoch)
    out = {"batch_seed": np.int64(BATCH_SEED), "epoch": np.int64(epoch),
           "coeffs": coeffs, "colloc": np.asarray(colloc, np.float32),
           "iters": np.asarray(ITERS, np.int64)}
    loss_fn = make_loss_fn(problem)
    out["loss_0"] = np.float32(loss_fn(params, colloc, None)[0])
    for k in ITERS:
        kexp = override(exp, {"optimizer.lbfgs.max_iters": k})
        kproblem = build_problem(kexp)
        state = TrainState(params=params, opt_state=None, admm=None, colloc=colloc,
                           key=jax.random.PRNGKey(0), epoch=jnp.asarray(epoch, jnp.int32))
        _, metrics = jax.jit(make_lbfgs_step(kproblem))(state)
        # the solve's counts: the same solve again, outside the step
        x0, unravel = ravel_pytree(params)
        kloss = make_loss_fn(kproblem)
        cfg = kexp.optimizer.lbfgs
        res = jax.jit(lambda x: lbfgs_minimize(
            lambda y: kloss(unravel(y), colloc, None)[0], x, max_iters=cfg.max_iters,
            history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol, max_ls=cfg.max_ls))(x0)
        if int(res.n_iters) != int(metrics["lbfgs_iters"]):
            raise RuntimeError("the solve outside the step takes other iterations")
        out[f"f_{k}"] = np.float32(res.f)
        out[f"n_iters_{k}"] = np.int64(res.n_iters)
        out[f"n_evals_{k}"] = np.int64(res.n_evals)
        out[f"metrics_{k}"] = np.asarray([float(metrics[name]) for name in METRIC_KEYS],
                                         np.float32)
        out[f"sums_{k}"] = leaf_sums(unravel(res.x)["net"])
        print(f"max_iters {k}: f {float(res.f)!r}, n_iters {int(res.n_iters)}, "
              f"n_evals {int(res.n_evals)}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
