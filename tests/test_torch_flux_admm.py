"""Port parity for the weak-form ADMM (``loss.admm_form='flux'``, the rest of
slice 2b-iii): ADMM's z and dual live on the weak-form cells. The problem's
``admm_flux`` semantics, the ADMM init at the cells, one step's loss and
gradient and a 3-step replay with z and the dual after each step against
JAX, for the Euler system and for Burgers; an ensemble's members and the
L-BFGS phase on it, the CLI, and the refusals that stay (microbatching, K3
and K10's narrow scope).

Inputs come from numpy seeds; JAX runs on the CPU at small nets (3 layers,
width 8). Tolerances, each with its reason:
- the cell residuals and z / dual: rtol 1e-4 / atol 1e-5 max|JAX| (the
  training row's: float32 cell means in another order);
- losses rtol 1e-4; gradients rtol 1e-4 / atol 1e-5 max|g| per leaf, or the
  float64 criterion (the port's error against float64 at most 4x JAX's plus
  1e-6 max|exact|) where a leaf's sum cancels; one Adam step's params to a
  tenth of the learning rate.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.parallel import ensemble as jens
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch import interop
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
F64_FACTOR = 4.0
CASES = {
    "euler": ("euler_admm", {"model.layers": (2, 8, 8, 8, 3), "sampling.n_f": 64,
                             "data.n_u": 32, "loss.admm_form": "flux"}),
    "burgers": ("twosin_weak", {"model.layers": (2, 8, 8, 8, 1), "sampling.n_f": 64,
                                "data.n_u": 32, "loss.residual_kind": "admm",
                                "loss.admm_form": "flux", "loss.causal_eps": 0.0}),
}
STEPS = 3


def _close(name, got, want, rtol=1e-4, atol_rel=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=name)


def _assert_grad(name, got, want, exact):
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


def _setup(case):
    preset, upd = CASES[case]
    jexp = joverride(JPRESETS[preset], upd)
    jtr = jtrainer.Trainer(jexp)
    ttr = ttrainer.Trainer(override(get_preset(preset), upd), device="cpu")
    return jtr, ttr


def _components(a):
    return a if isinstance(a, tuple) else (a,)


def _state_from_jax(jstate):
    tree = {"params": jstate.params, "count": 0, "mu": jstate.opt_state[0].mu,
            "nu": jstate.opt_state[0].nu, "colloc": jstate.colloc, "epoch": 0,
            "z": jstate.admm.z, "dual": jstate.admm.dual}
    return interop.train_state_from_jax(jax.tree_util.tree_map(np.asarray, tree), CPU, key=1234)


@pytest.mark.parametrize("form,kind,want", [("flux", "admm", True), ("strong", "admm", False),
                                            ("flux", "mean_sq", False)])
def test_admm_flux_semantics_match_jax(form, kind, want):
    """admm_flux is ADMM on the weak form, as JAX's; flux decides the
    residual the loss takes; an unknown form raises."""
    upd = {"loss.admm_form": form, "loss.residual_kind": kind}
    jp = jtrainer.build_problem(joverride(JPRESETS["euler_admm"], dict(
        upd, **{"model.layers": (2, 8, 3)})))
    tp = ttrainer.build_problem(override(get_preset("euler_admm"), dict(
        upd, **{"model.layers": (2, 8, 3)})), "cpu")
    assert tp.admm_flux == jp.admm_flux == want
    assert tp.flux == want
    bad = ttrainer.build_problem(override(get_preset("euler_admm"), {
        "loss.admm_form": "cells", "model.layers": (2, 8, 3)}), "cpu")
    with pytest.raises(ValueError, match="admm_form"):
        _ = bad.admm_flux


@pytest.mark.parametrize("case", sorted(CASES))
def test_admm_init_lives_on_the_cells(case):
    """z = the cell residuals at the initial batch, dual = 1, from the same
    params and points as JAX's init."""
    jtr, ttr = _setup(case)
    jstate = jtr.init_state()
    state = _state_from_jax(jstate)
    params = state.params
    z = ttrainer.admm_init(ttr.problem.training_residuals(params, state.colloc)).z
    cells = ttr.problem.flux_residuals_and_entropy(params, state.colloc)[0]
    for i, (g, c, w) in enumerate(zip(_components(z), _components(cells),
                                      _components(jstate.admm.z))):
        assert torch.equal(g, c)
        _close(f"z{i}", g.numpy(), np.asarray(w))
    fresh = ttr.init_state()
    assert all(torch.equal(d, torch.ones_like(d)) for d in _components(fresh.admm.dual))
    strong = ttr.problem.residuals_chunked(fresh.params, fresh.colloc)
    assert not torch.equal(_components(fresh.admm.z)[0], _components(strong)[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_flux_admm_step_and_replay_match_jax(case):
    """One step's loss terms and every gradient leaf from JAX's initial
    params and batch (z and the dual initialized by each package at them),
    then STEPS JAX Adam epochs replayed at JAX's batches: the metrics, the
    params after the first step, and z and the dual on the new cells after
    each step."""
    jtr, ttr = _setup(case)
    jp, tp = jtr.problem, ttr.problem
    jstate = jtr.init_state()
    (_, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jstate.params, jstate.colloc, jstate.admm, None)
    state = _state_from_jax(jstate)
    # each side's z is its own r(w_0) at the batch (the init's semantics): at
    # the init r - z cancels exactly in each, so no side's rounding of r
    # shows up multiplied by rho
    state = state._replace(admm=ttrainer.admm_init(tp.training_residuals(state.params,
                                                                         state.colloc)))
    grads, auxs = {}, {}
    for dtype in (torch.float32, torch.float64):
        preset, upd = CASES[case]
        prob = tp if dtype == torch.float32 else ttrainer.build_problem(
            override(get_preset(preset), dict(upd, **{"model.dtype": "float64"})), "cpu")
        cast = lambda t: t.to(dtype).clone()  # noqa: E731
        params = ttrainer.tree_map(lambda t: cast(t).requires_grad_(True), state.params)
        with torch.no_grad():
            admm = ttrainer.admm_init(prob.training_residuals(params, state.colloc.to(dtype)))
        loss, aux = ttrainer.make_loss_fn(prob)(params, state.colloc.to(dtype), admm)
        grads[dtype] = [g.detach().numpy() for g in torch.autograd.grad(
            loss, k_taylor2.net_leaves(params["net"]))]
        auxs[dtype] = aux
    for k in ("loss", "data_term", "res_term"):
        np.testing.assert_allclose(float(auxs[torch.float32][k].detach()), float(jaux[k]),
                                   rtol=1e-4, err_msg=k)
    layers = len(tp.spec.layers) - 1
    jleaves = [jgrad["net"][i][k] for i in range(layers) for k in ("W", "b")]
    # Burgers' output bias: its gradient sums the cells' edge cotangents of
    # +-w / (2 h), which cancel to 1e-4 of their sum, so its float32 value is
    # the reduction order's (PyTorch's CPU sum against XLA's); that leaf is
    # held through the first step's params below
    skip = {2 * layers - 1} if case == "burgers" else set()
    for i, (g, w, e) in enumerate(zip(grads[torch.float32], jleaves, grads[torch.float64])):
        if i not in skip:
            _assert_grad(f"leaf {i}", g.ravel(), np.asarray(w).ravel(), e.ravel())
    jstep = jax.jit(jtrainer.make_adam_step(jp, jtr.optimizer))
    step = ttrainer.make_adam_step(tp, ttr.learning_rate)
    lr = tp.exp.optimizer.learning_rate
    for k in range(STEPS):
        jstate, jm = jstep(jstate)
        state, m = step(state, new_colloc=torch.from_numpy(np.array(jstate.colloc)))
        for name in ("loss", "data_term", "res_term", "admm_misfit"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4,
                                       atol=1e-6 * abs(float(jm["loss"])),
                                       err_msg=f"step {k} {name}")
        for i, (g, w) in enumerate(zip(_components(state.admm.z), _components(jstate.admm.z))):
            _close(f"step {k} z{i}", g.numpy(), np.asarray(w))
        for i, (g, w) in enumerate(zip(_components(state.admm.dual),
                                       _components(jstate.admm.dual))):
            _close(f"step {k} dual{i}", g.numpy(), np.asarray(w))
        if k == 0:
            want = [jstate.params["net"][i][kk] for i in range(layers) for kk in ("W", "b")]
            for i, (g, w) in enumerate(zip(k_taylor2.net_leaves(state.params["net"]), want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0.1 * lr,
                                           err_msg=f"leaf {i}")


def test_flux_admm_ensemble_members_equal_solo_runs():
    """An ensemble's members start as solo runs of their seeds (z on the
    cells) and stay bit-equal to them through a 2-epoch chunk."""
    _, ttr = _setup("euler")
    seeds = (3, 4)
    stacked = tens.init_ensemble_states(ttr, seeds)
    run = tens.make_ensemble_chunk(ttr, 2)
    stacked, _ = run(stacked)
    for i, s in enumerate(seeds):
        solo, _ = ttrainer.run_chunk(ttr._adam_step, ttr.init_state(seed=s), 2)
        member = tens.unstack_states(stacked, len(seeds))[i]
        for a, b in zip(k_taylor2.net_leaves(solo.params["net"]),
                        k_taylor2.net_leaves(member.params["net"])):
            assert torch.equal(a, b)
        for a, b in zip(solo.admm.z, member.admm.z):
            assert torch.equal(a, b)


def test_flux_admm_lbfgs_phase_updates_the_cells():
    """The L-BFGS phase on the flux ADMM (the CPU's host loop; on the card
    AutogradLBFGS, since K10's narrow scope refuses the weak-form ADMM): one
    outer epoch lowers the loss and leaves z on the new cells."""
    _, ttr = _setup("euler")
    exp = override(ttr.exp, {"optimizer.kind": "hybrid", "optimizer.switch_epoch": 0,
                             "optimizer.lbfgs.max_iters": 5})
    problem = ttrainer.build_problem(exp, "cpu")
    state = ttr.init_state()
    loss0 = float(ttrainer.make_loss_fn(problem)(state.params, state.colloc, state.admm)[0])
    step = ttrainer.make_lbfgs_step(problem)
    new, m = step(state)
    assert float(m["loss"]) < loss0
    cells = problem.flux_residuals_and_entropy(new.params, new.colloc)[0]
    for z, r, d in zip(new.admm.z, cells, state.admm.dual):
        assert z.shape == r.shape and torch.isfinite(z).all()
    spec = problem.spec
    assert any("weak-form ADMM" in why for why in k_lbfgs.lbfgs_device_supported(exp, spec))
    assert any("weak-form ADMM" in why for why in k_fused.fused_step_supported(
        override(get_preset("abgrall_admm"), {"loss.admm_form": "flux"}), spec))


def test_flux_admm_trains_from_the_cli(tmp_path):
    """``train --set loss.admm_form=flux`` on a tiny euler_admm through the
    port's CLI."""
    from pinns_tpu_torch import cli
    from pinns_tpu_torch.train import checkpoint as ckpt_io

    out = tmp_path / "run"
    rc = cli.main(["train", "--preset", "euler_admm", "--device", "cpu", "--epochs", "2",
                   "--out-dir", str(out), "--set", "loss.admm_form=flux",
                   "--set", "model.layers=(2, 8, 3)", "--set", "sampling.n_f=32",
                   "--set", "data.n_u=16", "--set", "train.chunk=2"])
    assert rc in (0, None)
    state = ckpt_io.load_checkpoint(str(out / "euler_admm_final.ckpt"), "cpu")
    assert len(state.admm.z) == 3 and all(torch.isfinite(z).all() for z in state.admm.z)


def test_flux_admm_refuses_microbatching_as_jax_does():
    _, ttr = _setup("euler")
    problem = copy.copy(ttr.problem)
    problem.exp = override(problem.exp, {"sampling.microbatch": 2})
    state = ttr.init_state()
    with pytest.raises(ValueError, match="weak-form"):
        ttrainer.make_loss_fn(problem)(state.params, state.colloc, state.admm)
    jp = jtrainer.build_problem(joverride(JPRESETS["euler_admm"], dict(
        CASES["euler"][1], **{"sampling.microbatch": 2})))
    assert jp.admm_flux
    assert jens is not None
