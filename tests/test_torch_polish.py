"""Port parity for ``polish``, the float64 L-BFGS polish of a checkpoint
(``pinns_tpu/cli.py:486-557``), and for the float64 modes it runs on the
card, held on the CPU:

(a) the port's polish core (``train/polish.py::polish``: the host loop over
    ``make_loss_fn``) against JAX's ``lbfgs_minimize_pytree`` over JAX's
    ``make_loss_fn`` under ``jax.enable_x64``, from the same params, batch
    and ADMM state, for burgers_forward, burgers_inverse (trainable lambda1
    and the exp-transformed lambda2) and abgrall_admm (an ADMM state): equal
    n_iters, n_evals and converged, x within 1e-8 max|x|, f within 1e-12 of
    JAX's loss at the port's iterate and of JAX's f (1e-9 on burgers_inverse,
    whose solve amplifies a one-ulp change of x0 to that size);
(b) K10's float64 plain versions, driven by ``AutogradLBFGS`` on CPU
    tensors, against the host loop in float64: equal n_iters, n_evals and
    converged, x within 1e-10 max|x| (the sums run in other orders);
(c) the plain float64 Taylor-2 forward and reverse (K1's and K2's plain
    versions) and K5's backward against JAX's ``mlp_taylor_2`` / ``mlp_apply``
    and their VJPs under x64, within 1e-12 of each stream's or leaf's max;
(d) the CLI round trip on the CPU: ``train --device cpu``, ``polish
    --device cpu`` (the polished checkpoint with meta ``polished: true``, its
    loss no higher), ``eval --checkpoint`` of it;

and the float64 modes' plans and refusals: on a CUDA device float64 outside
K10's float64 mode and the narrow K1, K2 and K5 raises, naming the later
slice; the wrappers' spec checks run before their device checks, so the
refusals show on CPU tensors. Inputs come from numpy with a seed.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.models.mlp import mlp_apply as jax_mlp_apply
from pinns_tpu.opt.lbfgs import lbfgs_minimize_pytree as jax_lbfgs_pytree
from pinns_tpu.ops.taylor import mlp_taylor_2 as jax_taylor_2
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.cli import main as cli_main
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp, mlp_apply_reference
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.kernels import weakform as k_weakform
from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.opt.adam import adam_init
from pinns_tpu_torch.train import trainer as ttrainer
from pinns_tpu_torch.train.polish import FTOL, GTOL, polish
from torch_port_util import LB, NARROW, UB, numpy_params, numpy_points

GRID = "tests/fixtures/torch_port/twosin_burgers_shock.npz"
NET = (2, 12, 12, 1)
N_F = 256
MAX_ITERS = 30
X_RTOL_JAX = 1e-8
X_RTOL_K10 = 1e-10
F64_RTOL = 1e-12
F_RTOL_JAX = {"burgers_forward": 1e-12, "burgers_inverse": 1e-9, "abgrall_admm": 1e-12}
PRESETS = {"burgers_forward": 64, "burgers_inverse": 200, "abgrall_admm": 64}  # name -> n_u
LATER = "later slice"


def _updates(name):
    return {"model.layers": NET, "sampling.n_f": N_F, "data.n_u": PRESETS[name],
            "model.dtype": "float64"}


def _jax_problem(name):
    exp = joverride(JPRESETS[name], _updates(name))
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    build = (jds.interior_training_set if exp.data.selection == "interior"
             else jds.build_ic_bc_training_set)
    x_data, targets = build(ds, exp.data.n_u, seed=exp.data.seed, noise=exp.data.noise)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub), dtype=jnp.float64)
    return exp, jtrainer.Problem(exp=exp, dataset=ds, spec=spec,
                                 x_data=jnp.asarray(x_data, jnp.float64),
                                 targets={k: jnp.asarray(v, jnp.float64)
                                          for k, v in targets.items()})


def _port_problem(name):
    return ttrainer.build_problem(override(get_preset(name), _updates(name)), "cpu", dataset=GRID)


def _inputs(exp, seed):
    """The checkpoint's float64 contents from numpy: net, coefficients at
    the preset's start, batch, and an ADMM state where the preset has one."""
    rng = np.random.default_rng(seed)
    out = {"net": [{k: v.astype(np.float64) for k, v in layer.items()}
                   for layer in numpy_params(NET, seed)],
           "lam": (float(exp.pde.lambda1), float(exp.pde.lambda2)),
           "colloc": numpy_points(N_F, seed + 1).astype(np.float64)}
    if exp.loss.residual_kind == "admm":
        out["z"] = 0.1 * rng.standard_normal((N_F, 1))
        out["dual"] = 1.0 + 0.1 * rng.standard_normal((N_F, 1))
    return out


def _params(inp, asarray):
    return {"net": [{k: asarray(v) for k, v in layer.items()} for layer in inp["net"]],
            "coeffs": {"lambda1": asarray(np.full((1,), inp["lam"][0])),
                       "lambda2": asarray(np.full((1,), inp["lam"][1]))}}


def _port_state(inp):
    params = _params(inp, torch.from_numpy)
    admm = (ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"]))
            if "z" in inp else None)
    return ttrainer.TrainState(params=params, opt_state=adam_init(params), admm=admm,
                               colloc=torch.from_numpy(inp["colloc"]), key=0, epoch=0)


# -- (a) the polish core against JAX's --------------------------------------

@pytest.mark.parametrize("name", list(PRESETS))
def test_polish_matches_jax_float64(name):
    with jax.enable_x64(True):
        jexp, jp = _jax_problem(name)
        inp = _inputs(jexp, seed=81)
        jloss = jtrainer.make_loss_fn(jp)
        jcolloc = jnp.asarray(inp["colloc"])
        jadmm = (JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"]))
                 if "z" in inp else None)
        jparams, want = jax_lbfgs_pytree(
            lambda p: jloss(p, jcolloc, jadmm)[0], _params(inp, jnp.asarray),
            max_iters=MAX_ITERS, history=jexp.optimizer.lbfgs.history, ftol=1e-15, gtol=1e-12)
        want_x = np.asarray(ravel_pytree(jparams)[0])
        want_f = float(want.f)
        want_head = (int(want.n_iters), int(want.n_evals), bool(want.converged))
    problem = _port_problem(name)
    state, got = polish(problem, _port_state(inp), max_iters=MAX_ITERS)
    got_x = tl.ravel_tree(state.params)[0]
    assert got_x.dtype == torch.float64
    assert (got.n_iters, got.n_evals, got.converged) == want_head
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0,
                               atol=X_RTOL_JAX * np.abs(want_x).max())
    # f is the loss at the port's own iterate: JAX's loss there within 1e-12,
    # and JAX's f within 1e-12 where the iterates do not drift apart; on
    # burgers_inverse they part by 1.8e-10 of max|x| after 30 iterations, the
    # same branches taken, as a one-ulp change of x0 parts the port from
    # itself (test_polish_inverse_amplifies_one_ulp), so f is held there to 1e-9
    with jax.enable_x64(True):
        _, unravel = ravel_pytree(_params(inp, jnp.asarray))
        f_at = float(jloss(unravel(jnp.asarray(got_x.numpy())), jcolloc, jadmm)[0])
    np.testing.assert_allclose(float(got.f), f_at, rtol=F64_RTOL)
    np.testing.assert_allclose(float(got.f), want_f, rtol=F_RTOL_JAX[name])
    if name == "burgers_inverse":  # the trainable coefficients moved
        assert float(state.params["coeffs"]["lambda1"]) != inp["lam"][0]


def test_polish_inverse_amplifies_one_ulp():
    """Why burgers_inverse's f is held to JAX's within 1e-9 and not 1e-12:
    its solve turns a one-ulp change of one weight of x0 into a gap as large
    as the one between the port's and JAX's iterates (whose sums run in other
    orders), with the same iterations and evaluations on both sides."""
    problem = _port_problem("burgers_inverse")
    inp = _inputs(problem.exp, seed=81)
    moved = _port_state(inp)
    w = moved.params["net"][0]["W"].clone()  # the state shares inp's arrays
    w[0, 0] = torch.nextafter(w[0, 0], 2 * w[0, 0])
    moved.params["net"][0]["W"] = w
    a, res_a = polish(problem, _port_state(inp), max_iters=MAX_ITERS)
    b, res_b = polish(problem, moved, max_iters=MAX_ITERS)
    assert (res_a.n_iters, res_a.n_evals) == (res_b.n_iters, res_b.n_evals)
    xa, xb = tl.ravel_tree(a.params)[0], tl.ravel_tree(b.params)[0]
    assert float((xa - xb).abs().max()) > 1e-11 * float(xa.abs().max())
    assert abs(float(res_a.f) - float(res_b.f)) > F64_RTOL * abs(float(res_a.f))


def test_polish_passes_the_configured_rho():
    """JAX's polish calls loss_fn(p, colloc, admm) without a rho, so the loss
    takes loss.rho whatever the state's own rho override says."""
    problem = _port_problem("abgrall_admm")
    inp = _inputs(problem.exp, seed=82)
    a, res_a = polish(problem, _port_state(inp), max_iters=5)
    b, res_b = polish(problem, _port_state(inp)._replace(rho=1234.0), max_iters=5)
    assert torch.equal(tl.ravel_tree(a.params)[0], tl.ravel_tree(b.params)[0])
    assert float(res_a.f) == float(res_b.f)


# -- (b) K10's float64 plain versions against the host loop -----------------

@pytest.mark.parametrize("name", ["burgers_forward", "abgrall_admm"])
def test_k10_float64_plain_matches_host_loop(name):
    problem = _port_problem(name)
    inp = _inputs(problem.exp, seed=83)
    state = _port_state(inp)
    loss_fn = ttrainer.make_loss_fn(problem)
    x0, unravel = tl.ravel_tree(state.params)
    fun = lambda x: loss_fn(unravel(x), state.colloc, state.admm)[0]  # noqa: E731
    opts = dict(max_iters=MAX_ITERS, history=problem.exp.optimizer.lbfgs.history, ftol=FTOL,
                gtol=GTOL)
    solver = k_lbfgs.AutogradLBFGS()
    got = solver.minimize(fun, x0.detach(), **opts)
    want = tl.lbfgs_minimize(fun, x0.detach(), **opts)
    assert solver.bufs.dtype == torch.float64 and got.x.dtype == torch.float64
    assert (got.n_iters, got.n_evals, got.converged) == (want.n_iters, want.n_evals,
                                                          want.converged)
    branches = k_lbfgs.branches_taken(solver.bufs)
    assert "stored" in branches and "accept" in branches
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=X_RTOL_K10 * float(want.x.abs().max()))


def test_k10_float64_state_and_plan():
    """The float64 mode's buffers, constants and plan: double state, the
    constants rounded to double, the pairs streamed at 8x20 with a history
    of 50 (resident in float32), shared memory counted in 8-byte words."""
    n, m = 3_023, 50
    b = k_lbfgs.Buffers.alloc(n, m, "cpu", torch.float64)
    b.check()
    x0 = torch.from_numpy(np.random.default_rng(84).standard_normal(n))
    k_lbfgs.reset(b, x0, max_iters=10, ftol=FTOL, gtol=GTOL)
    assert b.sf[k_lbfgs.F_FTOL].item() == FTOL and b.sf[k_lbfgs.F_GTOL].item() == GTOL
    assert b.sf[k_lbfgs.F_EPS_CURV].item() == 1e-10  # not float32's rounding of it
    assert torch.equal(b.vec[k_lbfgs.XT], x0)
    with pytest.raises(ValueError, match="float64"):
        k_lbfgs.reset(b, x0.float(), max_iters=10)
    assert k_lbfgs.cluster_plan(n, m).resident
    plan = k_lbfgs.cluster_plan(n, m, 8)
    assert not plan.resident and plan.smem == k_lbfgs.direction_smem(n, m, False, 8)
    assert plan.smem == 2_048 + 8 * (4 * m + 2 * m)
    with pytest.raises(ValueError, match="float32 or float64"):
        k_lbfgs.Buffers.alloc(4, 2, "cpu", torch.float16).check()


@pytest.mark.parametrize("count", [0, 7, 50])
def test_k10_float64_plain_steps_keep_the_state_dtype(count):
    """A seeded float64 state stepped by the plain direction and control
    versions stays float64 and takes the float64 two-loop: d = -H g against
    the recursion spelled in numpy float64."""
    n, m = 301, 50
    b = k_lbfgs.seeded_state(n, m, count, 9, seed=count, dtype=torch.float64)
    k_lbfgs.direction(b)
    assert all(t.dtype == torch.float64 for t in b.tensors()[1:])
    g = b.vec[k_lbfgs.G].numpy()
    s_h, y_h, rho = b.hist[0].numpy(), b.hist[1].numpy(), b.rho.numpy()
    q, alpha = g.copy(), {}
    for j in range(count):
        i = (9 - 1 - j) % m
        alpha[i] = rho[i] * (s_h[i] @ q)
        q = q - alpha[i] * y_h[i]
    r = b.sf[k_lbfgs.F_GAMMA].item() * q
    for j in range(count):
        i = (9 - count + j) % m
        r = r + (alpha[i] - rho[i] * (y_h[i] @ r)) * s_h[i]
    d = b.vec[k_lbfgs.D].numpy()
    np.testing.assert_allclose(d, -r, rtol=0, atol=1e-12 * np.abs(r).max())
    b.vec[k_lbfgs.GT] = torch.from_numpy(np.random.default_rng(count).standard_normal(n))
    b.sf[k_lbfgs.F_PHI_T] = 0.5
    k_lbfgs.control(b)
    assert b.sf.dtype == torch.float64 and int(b.si[k_lbfgs.I_LS_EVALS]) == 1


# -- (c) the plain float64 Taylor-2 and K5 reverse against JAX --------------

def _f64_case(layers, seed, n=53):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    np_params = [{k: v.astype(np.float64) for k, v in layer.items()}
                 for layer in numpy_params(layers, seed)]
    x = numpy_points(n, seed + 1).astype(np.float64)
    rng = np.random.default_rng(seed + 2)
    cot = [rng.standard_normal((n, layers[-1])) for _ in range(4)]
    return spec, np_params, x, cot


def _hold(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_RTOL * np.abs(w).max(),
                                   err_msg=f"leaf/stream {i}")


@pytest.mark.parametrize("layers", [NET, NARROW])
def test_plain_taylor2_float64_matches_jax(layers):
    spec, np_params, x, cot = _f64_case(layers, seed=85)
    params = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in np_params]
    got = mlp_taylor_2_reference(spec, params, torch.from_numpy(x))
    grads = k_taylor2.taylor2_backward_reference(spec, params, torch.from_numpy(x),
                                                 [torch.from_numpy(c) for c in cot])
    with jax.enable_x64(True):
        jspec = JSpec(layers=layers, lb=LB, ub=UB, dtype=jnp.float64)
        jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
        want, vjp = jax.vjp(lambda p: jax_taylor_2(jspec, p, jnp.asarray(x)), jparams)
        (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cot))
        want = [np.asarray(w) for w in want]
        jleaves = [np.asarray(layer[k]) for layer in jgrad for k in ("W", "b")]
    assert all(t.dtype == torch.float64 for t in got)
    _hold([t.numpy() for t in got], want)
    _hold([g.numpy() for g in grads], jleaves)


@pytest.mark.parametrize("layers", [NET, NARROW])
def test_plain_mlp_float64_matches_jax(layers):
    spec, np_params, x, cot = _f64_case(layers, seed=86)
    params = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in np_params]
    got = mlp_apply_reference(spec, params, torch.from_numpy(x))
    grads = k_mlp.mlp_backward_reference(spec, params, torch.from_numpy(x),
                                         torch.from_numpy(cot[0]))
    with jax.enable_x64(True):
        jspec = JSpec(layers=layers, lb=LB, ub=UB, dtype=jnp.float64)
        jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
        want, vjp = jax.vjp(lambda p: jax_mlp_apply(jspec, p, jnp.asarray(x)), jparams)
        (jgrad,) = vjp(jnp.asarray(cot[0]))
        jleaves = [np.asarray(layer[k]) for layer in jgrad for k in ("W", "b")]
    _hold([got.numpy()], [np.asarray(want)])
    _hold([g.numpy() for g in grads], jleaves)


# -- (d) the CLI round trip on the CPU --------------------------------------

CLI_SETS = ["--set", "model.layers=(2,12,12,1)", "--set", f"sampling.n_f={N_F}",
            "--set", "sampling.strategy=fixed_lhs", "--set", f"data.dataset={GRID}"]


def test_cli_train_polish_eval_round_trip(tmp_path, capsys):
    out_dir = str(tmp_path)
    assert cli_main(["train", "--preset", "burgers_forward", *CLI_SETS,
                     "--set", "train.chunk=100", "--set", "optimizer.kind=adam",
                     "--epochs", "300", "--out-dir", out_dir, "--device", "cpu"]) == 0
    ckpt = f"{out_dir}/burgers_forward_final.ckpt"
    capsys.readouterr()
    assert cli_main(["polish", "--preset", "burgers_forward", *CLI_SETS, "--checkpoint", ckpt,
                     "--max-iters", "60", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("f64 L-BFGS: ") and "converged=" in lines[0]
    summary = json.loads(lines[1])
    polished = ckpt + ".polished.ckpt"
    assert lines[2] == polished
    with open(polished + ".json") as fh:
        assert json.load(fh) == {"polished": True}
    exp64 = override(get_preset("burgers_forward"),
                     {"model.layers": NET, "sampling.n_f": N_F, "sampling.strategy": "fixed_lhs",
                      "model.dtype": "float64"})
    trainer = ttrainer.Trainer(exp64, device="cpu", dataset=GRID)
    loss_fn = ttrainer.make_loss_fn(trainer.problem)
    before, after = trainer.load_checkpoint(ckpt), trainer.load_checkpoint(polished)
    assert after.params["net"][0]["W"].dtype == torch.float64
    assert after.colloc.dtype == torch.float64
    loss = [float(loss_fn(s.params, s.colloc, s.admm)[0]) for s in (before, after)]
    assert loss[1] <= loss[0]
    assert cli_main(["eval", "--preset", "burgers_forward", *CLI_SETS, "--checkpoint", polished,
                     "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isclose(ev["rel_l2_u"], summary["rel_l2_u"], rel_tol=1e-5)


def test_polish_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device, polish runs on the card and raises where none is
    visible, before it reads the checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["polish", "--preset", "burgers_forward", *CLI_SETS,
                  "--checkpoint", str(tmp_path / "missing.ckpt")])


def test_checkpoint_loads_into_float64(tmp_path):
    """A float32 checkpoint loaded with dtype float64: every floating leaf of
    the params, the batch and the ADMM state in float64, the Adam moments as
    saved (JAX's state._replace keeps them)."""
    from pinns_tpu_torch.train import checkpoint as ckpt_io

    problem = ttrainer.build_problem(override(get_preset("abgrall_admm"), {
        "model.layers": NET, "sampling.n_f": N_F}), "cpu", dataset=GRID)
    state = ttrainer.Trainer(problem.exp, problem=problem).init_state()
    path = str(tmp_path / "s.ckpt")
    ckpt_io.save_checkpoint(path, state)
    got = ckpt_io.load_checkpoint(path, "cpu", torch.float64)
    for a, b in zip(tl.ravel_tree(got.params)[0], tl.ravel_tree(state.params)[0]):
        assert a.dtype == torch.float64 and float(a) == float(b)
    assert got.colloc.dtype == got.admm.z.dtype == got.admm.dual.dtype == torch.float64
    assert all(t.dtype == torch.float32 for t in k_taylor2.net_leaves(got.opt_state.mu["net"]))
    same = ckpt_io.load_checkpoint(path, "cpu")
    assert same.colloc.dtype == torch.float32


def test_polish_needs_float64():
    problem = ttrainer.build_problem(override(get_preset("burgers_forward"), {
        "model.layers": NET, "sampling.n_f": N_F}), "cpu", dataset=GRID)
    state = ttrainer.Trainer(problem.exp, problem=problem).init_state()
    with pytest.raises(ValueError, match="float64"):
        polish(problem, state, max_iters=1)


# -- the float64 modes' plans and refusals ----------------------------------

def test_float64_launch_plans():
    cfg = k_taylor2.launch_config(NARROW, dtype=torch.float64)
    assert cfg.design == "narrow" and cfg.tile % 4 == 0 and cfg.tile <= 64
    assert cfg.threads <= 256 and cfg.threads % 32 == 0
    assert cfg.smem == 8 * 2 * 4 * 20 * (cfg.tile + 4) <= 112 * 1024
    plan = k_taylor2.f64_backward_plan(NARROW, 10_000)
    assert plan.grid == 264 and plan.n_params == 3_021
    assert plan.pstore == 8 * 4 * 20 * k_taylor2.F64_TILE  # 8 hidden layers
    assert k_taylor2.f64_backward_plan(NARROW, 1).grid == 1
    tile, threads = k_mlp.forward_config(NARROW, 8)
    assert threads <= 256 and k_mlp.smem_bytes(NARROW, tile, 2, 8) <= 112 * 1024
    tile, grid = k_mlp.backward_config(NARROW, 100, 8)
    assert k_mlp.smem_bytes(NARROW, tile, 3, 8) <= 200 * 1024 and grid == -(-100 // tile)


def _f64_spec(layers, **kw):
    return MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64, **kw)


def _f64_params(spec):
    return init_mlp(spec, torch.Generator().manual_seed(3), torch.device("cpu"))


@pytest.mark.parametrize("case", ["k1_tiled", "k2_wide", "k5_wide", "k1_paths", "k5_fourier",
                                  "k8s_members"])
def test_float64_outside_the_modes_raises_naming_the_later_slice(case):
    wide, narrow = (2, 40, 40, 1), (2, 8, 8, 1)
    x = torch.zeros(4, 2, dtype=torch.float64)
    cot = [torch.zeros(4, 1, dtype=torch.float64)] * 4
    with pytest.raises(NotImplementedError, match=LATER):
        if case == "k1_tiled":
            spec = _f64_spec(wide)
            k_taylor2.taylor2(spec, _f64_params(spec), x)
        elif case == "k2_wide":
            spec = _f64_spec(wide)
            k_taylor2.taylor2_backward(spec, _f64_params(spec), x, cot)
        elif case == "k5_wide":
            spec = _f64_spec(wide)
            k_mlp.mlp_forward(spec, _f64_params(spec), x)
        elif case == "k1_paths":
            spec = _f64_spec(narrow, n_paths=2)
            k_taylor2.taylor2(spec, _f64_params(spec), x)
        elif case == "k5_fourier":
            spec = _f64_spec(narrow, fourier=((1.0, 0.5), (0.25, 2.0)))
            k_mlp.mlp_backward(spec, _f64_params(spec), x, cot[0])
        else:
            spec = _f64_spec(narrow)
            k_taylor2.taylor2_members(spec, torch.zeros(2, spec.n_params, dtype=torch.float64),
                                      x)


def test_float64_narrow_modes_reach_the_device_check():
    """A narrow float64 spec passes the float64 checks: on a CPU tensor the
    wrappers then raise for the device, as for float32."""
    spec = _f64_spec((2, 8, 8, 1))
    params = _f64_params(spec)
    x = torch.zeros(4, 2, dtype=torch.float64)
    before = (k_taylor2.F64_LAUNCHES, k_mlp.F64_LAUNCHES)
    for call in (lambda: k_taylor2.taylor2(spec, params, x),
                 lambda: k_taylor2.taylor2_backward(spec, params, x, [x[:, :1]] * 4),
                 lambda: k_mlp.mlp_forward(spec, params, x),
                 lambda: k_mlp.mlp_backward(spec, params, x, x[:, :1].contiguous())):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert (k_taylor2.F64_LAUNCHES, k_mlp.F64_LAUNCHES) == before


def test_k7a_and_k7b_refuse_float64_naming_the_later_slice():
    spec = _f64_spec((2, 8, 8, 3))
    x = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=LATER):
        k_taylor1.taylor1(spec, _f64_params(spec), x)
    y = torch.zeros(4, 1, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=LATER):
        k_weakform.flux_forward("burgers", y, y, y, y, torch.zeros(2, dtype=torch.float64), 4)


def test_k3_and_adam_refuse_float64_naming_the_later_slice():
    exp = override(get_preset("abgrall_admm"), {"model.layers": NET, "sampling.n_f": N_F,
                                                "model.dtype": "float64"})
    problem = ttrainer.build_problem(exp, "cpu", dataset=GRID)
    assert any(LATER in why for why in k_fused.fused_step_supported(exp, problem.spec))
    with pytest.raises(NotImplementedError, match=LATER):
        k_lbfgs.DeviceLBFGS(problem)
    on_card = dataclasses.replace(problem, device=torch.device("cuda"))
    step = ttrainer.make_step(on_card, 1e-3)  # builds: polish and evaluate need the trainer
    state = ttrainer.Trainer(exp, problem=problem).init_state()
    with pytest.raises(NotImplementedError, match=LATER):
        step(state)
