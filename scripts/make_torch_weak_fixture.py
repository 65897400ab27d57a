"""Write the torch port's weak-form fixture from JAX runs on the CPU.

The PyTorch port trains ``twosin_weak`` and ``euler_inverse`` on the GPU,
where there is no jax. This script runs the JAX side once and stores what the
port is held to, in ``tests/fixtures/torch_port/weak_flux.npz``:

- ``flux_<kind>_*`` for kind ``burgers`` (the ``twosin_weak`` net, 8x20, on
  the TwoSin grid's bounds) and ``euler`` (the ``euler_inverse`` trunk,
  2x200x5x3, on the Euler grid's bounds), each at the preset's initial
  params: ``centers`` (N_CELLS, 2) uniform in the domain with some rows
  exactly on the bounds, at the corners and within a half-width of an edge;
  ``cot`` (N_CELLS, C) a cotangent; for each of ``visc`` and ``invisc`` the
  residual ``r`` (N_CELLS, C), the gradient ``grad`` (flat W_0, b_0, W_1, ...
  order) of sum(r * cot) with respect to the net, and ``gcoeffs``: (dlambda1,
  dlambda2) for Burgers, (0, dvisc) for Euler. Coefficients: Burgers lambda1
  0.377, lambda2 1e-3 (0 inviscid); Euler gamma 1.4, visc exp(-6) (0
  inviscid). The viscous Euler case also holds ``entropy``, the weak entropy
  violation;
- ``small_<kind>_*``: the same at a small net (``SMALL_LAYERS``), N 64:
  ``params`` (flat), ``centers``, ``r_visc``, ``r_invisc``;
- ``causal_*``: the causal penalty's cases (``CAUSAL_CASES``) at N 512
  times that include every bin edge, the bounds and points just inside them:
  ``t``, ``res`` (N, 3), and per case ``term_<i>`` and ``w_<i>``;
- for each of ``twosin_weak`` and ``euler_inverse`` (prefix ``<preset>_``)
  at seed 1234: ``layers``, ``lb``/``ub``, ``x_data``, ``params_0`` (flat),
  ``coeffs_0`` (raw lambda1, lambda2), ``loss_0``, ``grad_0`` and
  ``gcoeffs_0`` at the initial state; then ``STEPS`` JAX Adam epochs: for
  k = 0..STEPS the batch ``colloc_k`` step k trains on; ``metrics_k``
  (k >= 1) the metrics of step k-1 in the port's METRIC_KEYS order,
  ``coeffs_k`` and ``sums_k`` (each leaf's sum and sum of squares, float64)
  after step k-1; ``params_1`` the params after the first step;
- ``band_seeds``, ``band_epochs`` and ``band_rel_l2`` (seed,): twosin_weak's u
  rel-L2 after ``band_epochs`` Adam epochs of its cosine schedule, uncut.

Usage (a few minutes on a CPU, most of it the three band runs):

    JAX_PLATFORMS=cpu python scripts/make_torch_weak_fixture.py [--band-epochs 3000]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.losses.misfit import causal_residual_penalty  # noqa: E402
from pinns_tpu.models.mlp import MLPSpec  # noqa: E402
from pinns_tpu.ops.weakform import burgers_flux_residual, euler_flux_residuals  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402

FIXTURE = "tests/fixtures/torch_port/weak_flux.npz"
PRESETS = ("twosin_weak", "euler_inverse")
STEPS = 3
N_CELLS = 1000
SMALL_LAYERS = {"burgers": (2, 16, 16, 1), "euler": (2, 16, 16, 3)}
BURGERS_COEFFS = (0.377, 1e-3)
GAMMA, VISC = 1.4, math.exp(-6.0)
FRAC, QUAD = 0.02, 4
CAUSAL_BINS = 32
# (eps, relative, fields): the absolute form at eps 0 (plain binned mean) and
# at twosin_weak's 30, the relative form at 0.2, on one field and on three
CAUSAL_CASES = ((0.0, False, 1), (30.0, False, 1), (0.2, True, 1), (30.0, False, 3))
BAND_SEEDS = (1234, 7, 99)
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")


def flat(net) -> np.ndarray:
    return np.concatenate([np.asarray(layer[k], np.float32).ravel()
                           for layer in net for k in ("W", "b")])


def unflat(v, layers):
    out, at = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        w = jnp.asarray(v[at:at + din * dout].reshape(din, dout))
        at += din * dout
        b = jnp.asarray(v[at:at + dout].reshape(1, dout))
        at += dout
        out.append({"W": w, "b": b})
    return out


def leaf_sums(net) -> np.ndarray:
    leaves = [np.asarray(layer[k], np.float64) for layer in net for k in ("W", "b")]
    return np.asarray([(v.sum(), (v * v).sum()) for v in leaves])


def centers_with_bounds(n, lb, ub, hx, ht, seed) -> np.ndarray:
    """Uniform centers with rows on the bounds, at the corners and within a
    half-width of each edge (clipped cells)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(lb, ub, size=(n, 2)).astype(np.float32)
    lbx, lbt = (np.float32(v) for v in lb)
    ubx, ubt = (np.float32(v) for v in ub)
    special = [(lbx, lbt), (lbx, ubt), (ubx, lbt), (ubx, ubt)]
    for s in rng.uniform(0, 1, 6):
        x = np.float32(lb[0] + s * (ub[0] - lb[0]))
        t = np.float32(lb[1] + s * (ub[1] - lb[1]))
        special += [(lbx, t), (ubx, t), (x, lbt), (x, ubt)]
        special += [(lbx + np.float32(0.5 * hx * s), t), (ubx - np.float32(0.5 * hx * s), t),
                    (x, lbt + np.float32(0.5 * ht * s)), (x, ubt - np.float32(0.5 * ht * s))]
    special = np.asarray(special, np.float32)
    c[:len(special)] = special
    return c


def flux_case(kind, spec, net, centers, cot, viscous):
    """(r, grad, gcoeffs[, entropy]) of one flux residual case."""
    hx = FRAC * float(spec.ub[0] - spec.lb[0])
    ht = FRAC * float(spec.ub[1] - spec.lb[1])
    c = jnp.asarray(centers)
    if kind == "burgers":
        lam1 = jnp.full((1,), BURGERS_COEFFS[0], jnp.float32)
        lam2 = jnp.full((1,), BURGERS_COEFFS[1] if viscous else 0.0, jnp.float32)

        def f(params, co):
            r, _ = burgers_flux_residual(spec, params, c, co[0], co[1], hx, ht, QUAD,
                                         False, viscous)
            return r

        coeffs = (lam1, lam2)
    else:
        visc = jnp.full((1,), VISC if viscous else 0.0, jnp.float32)

        def f(params, co):
            rs, _ = euler_flux_residuals(spec, params, c, GAMMA, hx, ht, QUAD, False, co[1],
                                         viscous)
            return jnp.concatenate(rs, axis=1)

        coeffs = (jnp.zeros((1,), jnp.float32), visc)
    r = f(net, coeffs)
    g_net, g_co = jax.grad(lambda p, co: jnp.sum(f(p, co) * cot), argnums=(0, 1))(net, coeffs)
    out = {"r": np.asarray(r), "grad": flat(g_net),
           "gcoeffs": np.asarray([float(g_co[0][0]), float(g_co[1][0])], np.float32)}
    if kind == "euler" and viscous:
        _, ent = euler_flux_residuals(spec, net, c, GAMMA, hx, ht, QUAD, True, coeffs[1], True)
        out["entropy"] = np.asarray(ent)
    return out


def flux_part(states) -> dict:
    out = {}
    for kind, preset in (("burgers", "twosin_weak"), ("euler", "euler_inverse")):
        spec, net = states[preset]
        hx = FRAC * float(spec.ub[0] - spec.lb[0])
        ht = FRAC * float(spec.ub[1] - spec.lb[1])
        centers = centers_with_bounds(N_CELLS, spec.lb, spec.ub, hx, ht, seed=11)
        fields = spec.layers[-1]
        cot = np.random.default_rng(12).standard_normal((N_CELLS, fields)).astype(np.float32)
        out[f"flux_{kind}_centers"], out[f"flux_{kind}_cot"] = centers, cot
        for tag, viscous in (("visc", True), ("invisc", False)):
            for key, v in flux_case(kind, spec, net, centers, jnp.asarray(cot), viscous).items():
                out[f"flux_{kind}_{tag}_{key}"] = v
        layers = SMALL_LAYERS[kind]
        small = MLPSpec(layers=layers, lb=spec.lb, ub=spec.ub)
        rng = np.random.default_rng(13)
        params = []
        for din, dout in zip(layers[:-1], layers[1:]):
            params.append({"W": (rng.standard_normal((din, dout)) / math.sqrt(din)).astype(
                np.float32), "b": (0.1 * rng.standard_normal((1, dout))).astype(np.float32)})
        jnet = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
        sc = centers_with_bounds(64, spec.lb, spec.ub, hx, ht, seed=14)
        out[f"small_{kind}_params"], out[f"small_{kind}_centers"] = flat(params), sc
        for tag, viscous in (("visc", True), ("invisc", False)):
            zero = jnp.zeros((64, fields), jnp.float32)
            out[f"small_{kind}_r_{tag}"] = flux_case(kind, small, jnet, sc, zero, viscous)["r"]
    return out


def causal_part(lb, ub) -> dict:
    """The causal cases over ``CAUSAL_BINS`` bins of [lb, ub] (float32)."""
    lb, ub = np.float32(lb), np.float32(ub)
    span = np.float32(ub - lb)
    edges = lb + span * np.arange(CAUSAL_BINS + 1, dtype=np.float32) / np.float32(CAUSAL_BINS)
    rng = np.random.default_rng(21)
    inner = rng.uniform(lb, ub, 512 - 2 * len(edges)).astype(np.float32)
    t = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)), inner])
    t = np.clip(t, lb, ub).astype(np.float32)
    res = (0.3 * rng.standard_normal((t.shape[0], 3))).astype(np.float32)
    out = {"causal_t": t, "causal_res": res, "causal_bins": np.int64(CAUSAL_BINS),
           "causal_lb": lb, "causal_ub": ub,
           "causal_cases": np.asarray([(e, float(rel), f) for e, rel, f in CAUSAL_CASES])}
    for i, (eps, relative, fields) in enumerate(CAUSAL_CASES):
        r = tuple(jnp.asarray(res[:, j:j + 1]) for j in range(fields))
        term, w = causal_residual_penalty(r if fields > 1 else r[0], jnp.asarray(t), lb, ub,
                                          eps, CAUSAL_BINS, relative=relative)
        out[f"causal_term_{i}"], out[f"causal_w_{i}"] = np.float32(term), np.asarray(w)
    return out


def steps_part(preset):
    exp = get_preset(preset)
    trainer = Trainer(exp)
    problem = trainer.problem
    state = trainer.init_state()
    step = jax.jit(make_adam_step(problem, trainer.optimizer))
    loss_fn = make_loss_fn(problem)
    (loss0, _), g0 = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.colloc, state.admm, None)
    coeffs = lambda p: np.asarray(  # noqa: E731
        [float(p["coeffs"]["lambda1"][0]), float(p["coeffs"]["lambda2"][0])], np.float32)
    p = f"{preset}_"
    out = {
        p + "layers": np.asarray(problem.spec.layers, np.int64),
        p + "lb": np.asarray(problem.spec.lb, np.float64),
        p + "ub": np.asarray(problem.spec.ub, np.float64),
        p + "seed": np.int64(exp.train.seed),
        p + "x_data": np.asarray(problem.x_data),
        p + "params_0": flat(state.params["net"]),
        p + "coeffs_0": coeffs(state.params),
        p + "grad_0": flat(g0["net"]),
        p + "gcoeffs_0": coeffs(g0),
        p + "loss_0": np.float32(loss0),
    }
    net0 = state.params["net"]
    for k in range(STEPS + 1):
        out[f"{p}colloc_{k}"] = np.asarray(state.colloc)
        if k < STEPS:
            state, metrics = step(state)
            out[f"{p}metrics_{k + 1}"] = np.asarray(
                [float(metrics[m]) for m in METRIC_KEYS], np.float32)
            out[f"{p}sums_{k + 1}"] = leaf_sums(state.params["net"])
            out[f"{p}coeffs_{k + 1}"] = coeffs(state.params)
            if k == 0:
                out[p + "params_1"] = flat(state.params["net"])
    return out, (problem.spec, net0), problem


def band_part(band_epochs: int) -> dict:
    rels = []
    for seed in BAND_SEEDS:
        t0 = time.time()
        run = Trainer(override(get_preset("twosin_weak"), {
            "train.epochs": band_epochs, "train.seed": seed, "train.log_every": 0}))
        _, summary = run.train()
        rels.append(summary["rel_l2_u"])
        print(f"seed {seed}: rel_l2_u {rels[-1]} after {band_epochs} epochs "
              f"({time.time() - t0:.1f} s)", flush=True)
    return {"band_seeds": np.asarray(BAND_SEEDS, np.int64), "band_epochs": np.int64(band_epochs),
            "band_rel_l2": np.asarray(rels, np.float64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band-epochs", type=int, default=3_000)
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    out, states = {}, {}
    for preset in PRESETS:
        part, states[preset], problem = steps_part(preset)
        out.update(part)
        if preset == "twosin_weak":
            out.update(causal_part(problem.lb[1], problem.ub[1]))
    out.update(flux_part(states))
    out.update(band_part(args.band_epochs))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
