"""Write the torch port's ensemble-serving fixture from JAX on the CPU.

The PyTorch port serves ensembles on the GPU, where there is no jax. This
script runs the JAX side once and stores what the port is held to, in
``tests/fixtures/torch_port/ensemble_serve.npz``, for two ensembles:

- ``burgers``: burgers_forward's 8x20 net, E = 4: member 0 the JAX-trained
  net of ``burgers_forward_8x20.npz``, members 1..3 its leaves times
  (1 + 0.01 N(0, 1)), member i with lambda1 = lambda1 (1 + 0.01 i);
- ``euler``: euler_weak_fast's full-width trunk 2x200x5x3 with its two shock
  paths, E = 3: member 0 the JAX-trained ``band_params`` of
  ``euler_weak.npz``, members 1..2 perturbed the same way.

For each, with prefix ``<kind>_``: ``preset``, ``layers``, ``lb``/``ub``,
the path spec (Euler), ``params`` (E, P) flat in the port's order (W_0, b_0,
W_1, ..., then layer 0's path_c and path_a), ``lambda1``/``lambda2`` (E,),
``x`` the served points (Burgers: the 25,600 grid points; Euler: 8,192 of the
47,100, ``idx`` into the grid's ``X_star``), and JAX's ``ensemble_predict``
with ``want_dx`` at them: ``<name>_mean``, ``<name>_std`` per field and
``<name>_dx`` per network field; ``calibration`` a JSON string of JAX's
``uq_calibration`` rows on the preset's whole grid per Mondrian feature
({"std": ..., "dx": ...}); ``cal_idx`` the calibration subset those rows
drew (``default_rng(0)``, 1,024 points) and ``cal_mean``, ``cal_std`` and
``cal_dx`` (1,024, fields) JAX's whole-grid predictions there, per network
field in ``cal_fields`` order.

Usage (about ten seconds on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_ensemble_fixture.py
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.parallel.ensemble import ensemble_predict, uq_calibration  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "ensemble_serve.npz")
SOURCES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
EULER_POINTS = 8_192
PERTURB = 0.01


def unflatten(flat: np.ndarray, layers, n_paths: int, degree: int) -> list:
    """A flat vector in the port's order as JAX-layout numpy params."""
    widths = (layers[0] + n_paths,) + tuple(layers[1:])
    net, off = [], 0
    for din, dout in zip(widths[:-1], widths[1:]):
        w = flat[off:off + din * dout].reshape(din, dout)
        off += din * dout
        net.append({"W": w, "b": flat[off:off + dout].reshape(1, dout)})
        off += dout
    if n_paths:
        net[0]["path_c"] = flat[off:off + n_paths * (degree + 1)].reshape(n_paths, degree + 1)
        off += n_paths * (degree + 1)
        net[0]["path_a"] = flat[off:off + n_paths]
        off += n_paths
    assert off == flat.size, (off, flat.size)
    return net


def flatten(net) -> np.ndarray:
    leaves = [layer[k] for layer in net for k in ("W", "b")]
    leaves += [net[0][k] for k in ("path_c", "path_a") if k in net[0]]
    return np.concatenate([np.asarray(v, np.float32).ravel() for v in leaves])


def members(base: np.ndarray, n: int, seed: int) -> np.ndarray:
    """(n, P): the base and n - 1 copies with each entry times (1 + 0.01 N)."""
    rng = np.random.default_rng(seed)
    out = [base] + [base * (1.0 + PERTURB * rng.standard_normal(base.shape)) for _ in range(n - 1)]
    return np.stack(out).astype(np.float32)


def one(kind: str, preset: str, flat_members: np.ndarray, n_paths: int, degree: int,
        idx=None) -> dict:
    t0 = time.time()
    exp = get_preset(preset)
    trainer = Trainer(exp)
    spec = trainer.problem.spec
    e = flat_members.shape[0]
    lam1 = np.asarray([exp.pde.lambda1 * (1.0 + 0.01 * i) if exp.pde.kind == "burgers"
                       else exp.pde.lambda1 for i in range(e)], np.float32)
    lam2 = np.full(e, exp.pde.lambda2, np.float32)
    nets = [unflatten(f, spec.layers, n_paths, degree) for f in flat_members]
    tree = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *nets)
    stacked = types.SimpleNamespace(params={
        "net": tree, "coeffs": {"lambda1": jnp.asarray(lam1[:, None]),
                                "lambda2": jnp.asarray(lam2[:, None])}})
    x_star = np.asarray(trainer.problem.dataset.X_star, np.float32)
    x = x_star if idx is None else x_star[idx]
    out = {"preset": np.asarray(preset), "layers": np.asarray(spec.layers, np.int64),
           "lb": np.asarray(spec.lb, np.float64), "ub": np.asarray(spec.ub, np.float64),
           "params": flat_members, "lambda1": lam1, "lambda2": lam2, "x": x}
    if idx is not None:
        out["idx"] = np.asarray(idx, np.int64)
    if n_paths:
        out.update(n_paths=np.asarray(n_paths, np.int64), path_degree=np.asarray(degree, np.int64),
                   path_sharpness=np.asarray(spec.path_sharpness, np.float64),
                   gamma=np.asarray(exp.pde.gamma, np.float64))
    preds = ensemble_predict(trainer, stacked, x, want_dx=True)
    for name, p in preds.items():
        out[f"{name}_mean"] = np.asarray(p["mean"], np.float32)
        out[f"{name}_std"] = np.asarray(p["std"], np.float32)
        if "dx" in p:
            out[f"{name}_dx"] = np.asarray(p["dx"], np.float32)
    cal = {f: uq_calibration(trainer, stacked, mond_feature=f) for f in ("std", "dx")}
    out["calibration"] = np.asarray(json.dumps(cal))
    # the calibration subset of calibration_stats (seed 0, n_cal 1024) and
    # JAX's whole-grid predictions there: how far each score err / std moves
    # between the two packages bounds how far its order statistics may
    n = x_star.shape[0]
    cal_idx = np.random.default_rng(0).permutation(n)[:min(1024, n // 4)]
    grid = ensemble_predict(trainer, stacked, x_star, want_dx=True)
    fields = [f for f in grid if f in trainer.problem.dataset.star]
    out["cal_idx"] = cal_idx.astype(np.int64)
    out["cal_fields"] = np.asarray(fields)
    for stat in ("mean", "std", "dx"):
        out[f"cal_{stat}"] = np.concatenate(
            [np.asarray(grid[f][stat], np.float32)[cal_idx] for f in fields], axis=1)
    print(f"{kind}: {preset}, {e} members, {x.shape[0]} points, {time.time() - t0:.1f} s",
          flush=True)
    return {f"{kind}_{k}": v for k, v in out.items()}


def main() -> int:
    with np.load(os.path.join(SOURCES, "burgers_forward_8x20.npz")) as z:
        layers = tuple(int(v) for v in z["layers"])
        base = flatten([{"W": z[f"W{i}"], "b": z[f"b{i}"]} for i in range(len(layers) - 1)])
    out = one("burgers", "burgers_forward", members(base, 4, seed=16), 0, 0)
    with np.load(os.path.join(SOURCES, "euler_weak.npz")) as z:
        n_paths, degree = int(z["n_paths"]), int(z["path_degree"])
        base = np.asarray(z["band_params"], np.float32)
    idx = np.sort(np.random.default_rng(17).choice(47_100, EULER_POINTS, replace=False))
    out.update(one("euler", "euler_weak_fast", members(base, 3, seed=18), n_paths, degree, idx))
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE}: {os.path.getsize(FIXTURE) / 1e6:.2f} MB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
