"""Port parity for microbatching (``train/trainer.py::_residual_term`` with
``sampling.microbatch`` > 1), the remat policies, the ``--set`` overrides of
the train CLI, a tiny mixed, microbatched run through ``Trainer.train`` on the
CPU, and the scale fixture's provenance.

Net 2 -> 16x3 -> 1, N_f = 64 in 8 microbatches, N_u = 16, on the TwoSin grid;
params and points from numpy seeds. Tolerances as the JAX package's own
microbatch tests (``tests/test_microbatch.py``): microbatched against
monolithic loss rtol 2e-5, gradient rtol 1e-4 / atol 1e-6; the remat policies
against each other loss rtol 1e-6, gradient rtol 1e-5 / atol 1e-7; against
JAX's microbatched loss the float32 tolerances of ``tests/test_torch_train.py``
(rtol 1e-4, atol 1e-5 max|g| per leaf).
"""

import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.cli import _parse_sets as jax_parse_sets
from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.cli import parse_sets
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import SMALL, numpy_params, numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
SCALE_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "burgers_scale_steps.npz")
N_F, N_U, M = 64, 16, 8
LAM1, LAM2 = 1.0, 0.01 / math.pi
KINDS = ["admm", "mean_sq", "l1_sq_norm", "l2_sq_norm"]


def _updates(kind, **extra):
    return {"model.layers": SMALL, "sampling.n_f": N_F, "data.n_u": N_U,
            "pde.lambda2": LAM2, "optimizer.kind": "adam", "loss.residual_kind": kind, **extra}


def _port_problem(updates):
    return ttrainer.build_problem(override(get_preset("abgrall_admm"), updates), "cpu",
                                  dataset=GRID)


def _jax_problem(updates):
    exp = joverride(JPRESETS["abgrall_admm"], updates)
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T})
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    return jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                            targets={k: jnp.asarray(v) for k, v in targets.items()})


def _inputs(seed=51):
    rng = np.random.default_rng(seed)
    return {"net": numpy_params(SMALL, seed), "colloc": numpy_points(N_F, seed + 1),
            "z": (0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
            "dual": (1.0 + 0.1 * rng.standard_normal((N_F, 1))).astype(np.float32)}


def _port_loss_and_grad(problem, inp):
    params = {"net": [{k: torch.tensor(v, requires_grad=True) for k, v in layer.items()}
                      for layer in inp["net"]],
              "coeffs": {"lambda1": torch.full((1,), LAM1), "lambda2": torch.full((1,), LAM2)}}
    leaves = [layer[k] for layer in params["net"] for k in ("W", "b")]
    admm = (ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"]))
            if problem.exp.loss.residual_kind == "admm" else None)
    loss, _ = ttrainer.make_loss_fn(problem)(params, torch.from_numpy(inp["colloc"]), admm)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("kind", KINDS)
def test_microbatched_matches_monolithic(kind):
    inp = _inputs()
    l1, g1 = _port_loss_and_grad(_port_problem(_updates(kind)), inp)
    l2, g2 = _port_loss_and_grad(_port_problem(_updates(kind, **{"sampling.microbatch": M})), inp)
    np.testing.assert_allclose(l2, l1, rtol=2e-5)
    for i, (a, b) in enumerate(zip(g2, g1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"leaf {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_microbatched_matches_jax(kind):
    upd = _updates(kind, **{"sampling.microbatch": M})
    inp = _inputs(seed=53)
    jp = _jax_problem(upd)
    jparams = {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in inp["net"]],
               "coeffs": {"lambda1": jnp.full((1,), LAM1, jnp.float32),
                          "lambda2": jnp.full((1,), LAM2, jnp.float32)}}
    jadmm = (JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"]))
             if kind == "admm" else None)
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jparams, jnp.asarray(inp["colloc"]), jadmm, None)
    jterm = jtrainer._residual_term(jp, jparams, jnp.asarray(inp["colloc"]), jadmm)
    tp = _port_problem(upd)
    loss, grads = _port_loss_and_grad(tp, inp)
    params = {"net": [{k: torch.tensor(v) for k, v in layer.items()} for layer in inp["net"]],
              "coeffs": {"lambda1": torch.full((1,), LAM1), "lambda2": torch.full((1,), LAM2)}}
    admm = (ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"]))
            if kind == "admm" else None)
    term = ttrainer._residual_term(tp, params, torch.from_numpy(inp["colloc"]), admm)
    np.testing.assert_allclose(float(term), float(jterm), rtol=1e-4)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    jflat = [np.asarray(jgrad["net"][i][k]) for i in range(len(SMALL) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(grads, jflat)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("kind", ["admm", "mean_sq"])
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policy_identical_math(kind, remat):
    """microbatch_remat changes only what the backward pass recomputes or
    keeps: loss and gradients equal the default 'full' policy's."""
    inp = _inputs(seed=55)
    full = _updates(kind, **{"sampling.microbatch": M})
    l1, g1 = _port_loss_and_grad(_port_problem(full), inp)
    l2, g2 = _port_loss_and_grad(_port_problem(dict(full, **{
        "sampling.microbatch_remat": remat, "sampling.microbatch_unroll": 2})), inp)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_remat_policy_unknown_rejected():
    problem = _port_problem(_updates("mean_sq", **{"sampling.microbatch": M,
                                                   "sampling.microbatch_remat": "sometimes"}))
    with pytest.raises(ValueError, match="microbatch_remat"):
        _port_loss_and_grad(problem, _inputs())


def test_microbatch_must_divide_the_batch():
    problem = _port_problem(_updates("mean_sq", **{"sampling.microbatch": 5}))
    with pytest.raises(ValueError, match="not divisible by microbatch"):
        _port_loss_and_grad(problem, _inputs())


@pytest.mark.parametrize("extra,match", [
    ({"loss.causal_eps": 1.0, "loss.residual_kind": "mean_sq"}, "causal_eps"),
    ({"loss.admm_form": "flux"}, "weak-form"),
], ids=["causal", "weak-form"])
def test_microbatching_refuses_what_jax_refuses(extra, match):
    """Causal weighting and the weak form need the whole batch in one pass
    (check_slice refuses them earlier; the residual term refuses them too)."""
    problem = _port_problem(_updates("admm", **{"sampling.microbatch": M}))
    problem = ttrainer.Problem(exp=override(problem.exp, extra), dataset=problem.dataset,
                               spec=problem.spec, x_data=problem.x_data, targets=problem.targets)
    with pytest.raises(ValueError, match=match):
        _port_loss_and_grad(problem, _inputs())


def test_residuals_chunked_matches_monolithic():
    inp = _inputs(seed=57)
    problem = _port_problem(_updates("admm", **{"sampling.microbatch": M}))
    params = {"net": [{k: torch.tensor(v) for k, v in layer.items()} for layer in inp["net"]],
              "coeffs": {"lambda1": torch.full((1,), LAM1), "lambda2": torch.full((1,), LAM2)}}
    colloc = torch.from_numpy(inp["colloc"])
    chunked = problem.residuals_chunked(params, colloc)
    assert chunked.shape == (N_F, 1)
    torch.testing.assert_close(chunked, problem.residuals(params, colloc), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pairs", [
    ["model.compute_dtype=bfloat16", "model.keep_streams=('xx',)"],
    ["sampling.n_f=4000", "sampling.microbatch_remat=dots", "model.mixed_elementwise=True"],
    ["loss.rho=1e-2", "model.layers=(2, 16, 1)", "data.dataset=/some/grid.npz"],
], ids=["policy", "scalars", "tuples-paths"])
def test_set_parsing_matches_jax(pairs):
    got = parse_sets(pairs)
    assert got == jax_parse_sets(pairs)
    assert [type(v) for v in got.values()] == [type(v) for v in jax_parse_sets(pairs).values()]
    exp = override(get_preset("burgers_scale"), {k: v for k, v in got.items()
                                                 if not k.startswith("data.")})
    for key, value in got.items():
        if key.startswith("data."):
            continue
        section, field = key.split(".")
        assert getattr(getattr(exp, section), field) == value


def test_set_rejects_a_pair_without_equals():
    with pytest.raises(SystemExit, match="key=value"):
        parse_sets(["model.compute_dtype"])


TINY_SCALE = {"model.layers": (2, 16, 16, 1), "sampling.n_f": 256, "sampling.microbatch": 4,
              "data.n_u": 32, "model.compute_dtype": "bfloat16", "model.keep_streams": ("xx",)}


def test_trainer_mixed_microbatched_on_cpu():
    """burgers_scale cut to a tiny net and batch, keep {xx} in 4 microbatches,
    through Trainer.train on the CPU: the loss is finite and falls."""
    exp = override(get_preset("burgers_scale"), dict(TINY_SCALE, **{
        "train.epochs": 30, "train.chunk": 10, "train.log_every": 10}))
    trainer = ttrainer.Trainer(exp, device="cpu")
    assert trainer.problem.spec.mixed and trainer.problem.spec.keep_streams == ("xx",)
    first = ttrainer.make_loss_fn(trainer.problem)(trainer.init_state().params,
                                                   trainer.init_state().colloc, None)[0]
    state, summary = trainer.train()
    last = ttrainer.make_loss_fn(trainer.problem)(state.params, state.colloc, None)[0]
    assert state.epoch == 30 and summary["epochs"] == 30
    assert np.isfinite(summary["rel_l2_u"]) and float(last) < float(first)


def test_cli_train_with_set_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    sets = [a for k, v in TINY_SCALE.items() for a in ("--set", f"{k}={v!r}")]
    proc = subprocess.run(
        [sys.executable, "-m", "pinns_tpu_torch", "train", "--preset", "burgers_scale",
         *sets, "--set", "model.mixed_elementwise=True", "--epochs", "3", "--chunk", "2",
         "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert summary["epochs"] == 3 and np.isfinite(summary["rel_l2_u"])


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_scale_fixture", os.path.join(REPO, "scripts", "make_torch_scale_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_fixture_rebuilds_and_its_step0_loss_matches():
    """The scale fixture's params and batches rebuild from its seed, its N_u
    set is the port's, and the port's plain step-0 loss at the preset's full
    width (8x200, 16,384 points in 2 microbatches) matches JAX's for the f32
    policy (rtol 1e-4) and lies within the f32 envelope for keep {xx} and max
    (|port - JAX| <= 2 |JAX mixed - JAX f32| + 1e-4 |JAX f32|)."""
    with np.load(SCALE_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    layers = tuple(int(w) for w in fx["layers"])
    params, batches = _fixture_script().draw(int(fx["seed"]), layers, fx["lb"], fx["ub"],
                                             int(fx["n_f"]), int(fx["steps"]))
    flat = np.concatenate([a.ravel() for layer in params for a in (layer["W"], layer["b"])])
    assert float(flat.astype(np.float64).sum()) == float(fx["params_sum"])
    assert float(sum(b.astype(np.float64).sum() for b in batches)) == float(fx["colloc_sum"])
    base = {"sampling.n_f": int(fx["n_f"]), "sampling.microbatch": int(fx["microbatch"])}
    policies = {"f32": {}, "keep_xx": {"model.compute_dtype": "bfloat16",
                                       "model.keep_streams": ("xx",)},
                "max": {"model.compute_dtype": "bfloat16", "model.mixed_elementwise": True}}
    for name, upd in policies.items():
        problem = ttrainer.build_problem(override(get_preset("burgers_scale"),
                                                  dict(base, **upd)), "cpu")
        assert problem.spec.layers == layers
        np.testing.assert_array_equal(problem.x_data.numpy(), fx["x_data"])
        np.testing.assert_array_equal(problem.targets["u"].numpy(), fx["u_data"])
        tparams = {"net": [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in params],
                   "coeffs": {"lambda1": torch.ones(1), "lambda2": torch.full(
                       (1,), problem.exp.pde.lambda2)}}
        with torch.no_grad():
            loss = float(ttrainer.make_loss_fn(problem)(tparams, torch.from_numpy(batches[0]),
                                                        None)[0])
        want, f32 = float(fx[f"{name}_loss"][0]), float(fx["f32_loss"][0])
        bound = 1e-4 * abs(want) if name == "f32" else 2 * abs(want - f32) + 1e-4 * abs(f32)
        assert abs(loss - want) <= bound, (name, loss, want, bound)
