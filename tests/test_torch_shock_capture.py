"""Port parity for slice 2b-iii, part 1: the Euler L-BFGS branch
(``euler_weak_tail``), K10 stepped over autograd through the Euler path
loss, the strong-form entropy penalty and gradient weighting
(``Problem.residuals_and_entropy``), the weak entropy of K7b's plain
versions at fine and coarse cells, K7b's entropy adjoint, and the
coarse-cell selection battery, each against the JAX package on the CPU.

Inputs come from numpy seeds; JAX runs on the CPU. Sizes: a path net 2 ->
16x2 -> 3 with 2 shock paths, N_f 64, Q 4; Burgers nets 2 -> 10x3 -> 1.
Tolerances, each with its reason:
- the L-BFGS step in float64 (both solvers take the same branches): metrics
  rtol 1e-6 (the metric row is float32), params and batch within 1e-9 of
  max|.|;
- the strong-form entropy and weighting: loss rtol 1e-5 in float32 (sums in
  another order), 1e-10 in float64; gradients rtol 1e-5 / atol 1e-5 max|g|
  per leaf in float32, rtol / atol 1e-10 in float64;
- the weak entropy and the coarse cells in float64: rtol 1e-9 / atol 1e-12
  max|.|; the selection battery in float32: rtol 1e-5 (means in another
  order);
- K7b's entropy adjoint (the kernel's formulas) against autograd in float64:
  1e-10 of each output's max.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinns_tpu.config import override as joverride
from pinns_tpu.data.sampling import uniform_box as juniform_box
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.parallel import ensemble as jens
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch import interop
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import ensemble_state_from_jax
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops import weakform as twf
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.ops.kernels import weakform as k7b
from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.train import trainer as ttrainer
from test_torch_ensemble import SEEDS, _jax_trainer, _jax_tree
from test_torch_ensemble import _trainer as _ens_trainer
from test_torch_lbfgs import GRID, X_RTOL
from test_torch_paths import TRUNK, path_net
from torch_port_util import numpy_params, numpy_points

CPU = torch.device("cpu")
SMALL = {"model.layers": TRUNK, "sampling.n_f": 64, "data.n_u": 64}
TAIL_EPOCH = 200_000  # euler_weak_tail's switch epoch: the curriculum's full bounds
BURGERS_NET = (2, 10, 10, 10, 1)
EULER_COEFFS = (1.0, 1e-3)  # the Euler presets' (lambda1, lambda2): lambda2 the viscosity


def _tree(net, lam1, lam2, asarray):
    return {"net": [{k: asarray(v) for k, v in layer.items()} for layer in net],
            "coeffs": {"lambda1": asarray(np.full((1,), lam1)),
                       "lambda2": asarray(np.full((1,), lam2))}}


def _euler_problems(preset, updates, jdtype):
    jp = jtrainer.build_problem(joverride(JPRESETS[preset], updates))
    tp = ttrainer.build_problem(override(get_preset(preset), updates), "cpu")
    assert jp.x_data.dtype == jdtype
    return jp, tp


def _centers(lb, ub, n, seed):
    """n points in the box, the first four on its corners (clipped cells)."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(lb[i], ub[i], n) for i in range(2)], axis=1)
    c[:4] = [(lb[0], lb[1]), (ub[0], ub[1]), (lb[0], ub[1]), (ub[0], lb[1])]
    return c


def _close(name, got, want, rtol, atol_rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(want).max()), 1e-300),
                               err_msg=name)


# -- (a) the Euler L-BFGS branch against JAX -------------------------------------

@pytest.mark.parametrize("strong", [(), (0,)], ids=["flux", "mixed"])
def test_euler_lbfgs_step_matches_jax(strong):
    """make_lbfgs_step on euler_weak_tail (a 2x16 path net, N_f 64) against
    JAX's in float64 at max_iters 4, from the same params and batch at the
    L-BFGS phase's first epoch; the port's tail is fed JAX's next batch,
    which both draw at the curriculum's full bounds. The flat order of a
    path net (path_a, path_c after W, b) is ravel_pytree's; lambda1 and
    lambda2 read the effective coefficients, as JAX's metrics do."""
    upd = dict(SMALL, **{"model.dtype": "float64", "optimizer.lbfgs.max_iters": 4,
                         "loss.strong_equations": strong})
    net = [{k: np.asarray(v, np.float64) for k, v in layer.items()} for layer in path_net(seed=31)]
    with jax.enable_x64(True):
        jp, tp = _euler_problems("euler_weak_tail", upd, jnp.float64)
        c = _centers(tp.lb, tp.ub, 64, 32)
        params = _tree(net, *EULER_COEFFS, jnp.asarray)
        jstate = jtrainer.TrainState(
            params=params, opt_state=None, admm=None, colloc=jnp.asarray(c),
            key=jax.random.key(5), epoch=jnp.asarray(TAIL_EPOCH, jnp.int32))
        jstate, jm = jax.jit(jtrainer.make_lbfgs_step(jp))(jstate)
        jm = {k: float(v) for k, v in jm.items()}
        want = {"params": np.asarray(ravel_pytree(jstate.params)[0]),
                "colloc": np.asarray(jstate.colloc)}
        jflat = np.asarray(ravel_pytree(params)[0])
    lb, ub = np.asarray(tp.lb), np.asarray(tp.ub)
    assert np.all(want["colloc"] >= lb) and np.all(want["colloc"] <= ub)
    assert want["colloc"][:, 1].max() > lb[1] + 0.9 * (ub[1] - lb[1])  # the full t range
    tparams = _tree(net, *EULER_COEFFS, torch.from_numpy)
    flat, _ = tl.ravel_tree(tparams)
    np.testing.assert_array_equal(flat.numpy(), jflat)
    tree = {"params": _tree(net, *EULER_COEFFS, np.asarray), "count": 0,
            "mu": _tree(net, 0.0, 0.0, np.zeros_like), "nu": _tree(net, 0.0, 0.0, np.zeros_like),
            "colloc": c, "epoch": TAIL_EPOCH, "key": 5}
    tstate = interop.train_state_from_jax(tree, CPU)
    assert ttrainer.Trainer(tp.exp, problem=tp)._phase(TAIL_EPOCH) == "lbfgs"
    tstate, tm = ttrainer.make_lbfgs_step(tp)(tstate, new_colloc=torch.from_numpy(want["colloc"]))
    assert sorted(tm) == sorted(jm) and tstate.epoch == TAIL_EPOCH + 1
    assert float(tm["lbfgs_iters"]) == jm["lbfgs_iters"] == 4.0
    assert (jm["lambda1"], jm["lambda2"]) == EULER_COEFFS
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-6, atol=1e-7 * abs(jm["loss"]),
                                   err_msg=k)
    got = tl.ravel_tree(tstate.params)[0].numpy()
    np.testing.assert_allclose(got, want["params"], rtol=0,
                               atol=X_RTOL * np.abs(want["params"]).max())
    # the batch of the next epoch: the port's own Philox draw at the full bounds
    own, _ = ttrainer.make_lbfgs_step(tp)(interop.train_state_from_jax(tree, CPU))
    assert own.colloc.shape == (64, 2)
    assert float(own.colloc[:, 1].max()) > lb[1] + 0.9 * (ub[1] - lb[1])


# -- (b) K10 over autograd: tests/test_torch_lbfgs_device.py's euler_weak_small ---

def test_done_flag_stops_control_and_direction():
    """Once si[I_DONE] is set the control and direction steps (plain here,
    the kernels' twins) leave every buffer as it is, whatever the
    evaluation wrote."""
    b = k_lbfgs.seeded_state(300, 5, 3, 1, seed=3)
    b.si[k_lbfgs.I_DONE] = 1
    b.vec[k_lbfgs.GT].normal_()
    b.sf[k_lbfgs.F_PHI_T] = -7.0
    before = b.clone()
    k_lbfgs.control(b)
    k_lbfgs.direction(b)
    assert all(torch.equal(u, v) for u, v in zip(b.tensors(), before.tensors()))


def test_trainer_takes_k10_over_autograd_for_float32_outside_k3():
    """The scope: euler_weak_tail and burgers_inverse are outside K3's, so a
    card trainer steps them on AutogradLBFGS; the CPU keeps the host loop
    (also float64 and host_loop=True on the card). The plan of the direction
    kernel at the Euler trunk's n = 162,413 and m = 50 is the streamed
    8-CTA layout within a block's shared memory. K3's and K10's narrow
    scopes refuse the entropy penalty and gradient weighting."""
    spec_euler = get_preset("euler_weak_tail")
    from pinns_tpu_torch.models.mlp import MLPSpec

    spec = MLPSpec(layers=spec_euler.model.layers, lb=(0.0, 0.0), ub=(1.0, 0.2),
                   n_paths=spec_euler.model.n_paths)
    assert any("pde.kind" in w for w in k_lbfgs.lbfgs_device_supported(spec_euler, spec))
    n = spec.n_params + 2
    assert n == 162_413
    plan = k_lbfgs.cluster_plan(n, 50)
    assert not plan.resident and plan.per == 159
    assert plan.smem == k_lbfgs.direction_smem(n, 50, False) <= k_lbfgs.SMEM_LIMIT
    assert k_lbfgs.direction_smem(n, 50, True) > k_lbfgs.SMEM_LIMIT
    _, tp = _euler_problems("euler_weak_tail", SMALL, jnp.float32)
    assert ttrainer.make_lbfgs_step(tp).solver is None
    # K3's scope and K10's narrow scope keep refusing the new loss terms
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused

    narrow = MLPSpec(layers=get_preset("abgrall_admm").model.layers, lb=(-1.0, 0.0),
                     ub=(1.0, 1.0))
    for extra in ({"loss.entropy_weight": 0.1}, {"loss.grad_weight_kappa": 1.0}):
        exp = override(get_preset("abgrall_admm"), extra)
        for why in (k_fused.fused_step_supported(exp, narrow),
                    k_lbfgs.lbfgs_device_supported(exp, narrow)):
            assert any("entropy, gradient or causal weighting" in w for w in why), why


# -- (c) the strong-form entropy -------------------------------------------------

def _burgers_problem(viscous, dtype, **extra):
    upd = {"model.layers": BURGERS_NET, "sampling.n_f": 64, "data.n_u": 16,
           "pde.lambda2": 0.01 / math.pi if viscous else 0.0, "optimizer.kind": "adam",
           "model.dtype": dtype, **extra}
    from test_torch_lbfgs import _jax_problem

    jp = _jax_problem(upd, jnp.float64 if dtype == "float64" else jnp.float32)
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), upd), "cpu", dataset=GRID)
    return jp, tp


def _euler_strong_problem(dtype, **extra):
    upd = {"model.layers": TRUNK, "sampling.n_f": 64, "data.n_u": 64, "model.dtype": dtype,
           **extra}
    return _euler_problems("euler_admm", upd, jnp.float64 if dtype == "float64" else jnp.float32)


def _inputs(kind, np_dtype, seed, lb, ub):
    """(net, coeffs, colloc, z, dual) for a loss: a Burgers 3x10 net or a
    2x16 Euler trunk with physical outputs (rho, E > 0, so the entropy's
    logarithms see positive arguments, as a trained net's do)."""
    rng = np.random.default_rng(seed)
    if kind == "euler":
        net = numpy_params(TRUNK, seed)
        net[-1]["b"] = np.asarray([[1.0, 0.2, 2.5]], np.float32)
        net[-1]["W"] = net[-1]["W"] * 0.6
        coeffs, fields = EULER_COEFFS, 3
    else:
        net = numpy_params(BURGERS_NET, seed)
        coeffs, fields = (1.0, 0.01 / math.pi if kind == "burgers_visc" else 0.0), 1
    colloc = _centers(lb, ub, 64, seed + 1)
    net = [{k: v.astype(np_dtype) for k, v in layer.items()} for layer in net]
    z = tuple((0.1 * rng.standard_normal((64, 1))).astype(np_dtype) for _ in range(fields))
    dual = tuple((1.0 + 0.1 * rng.standard_normal((64, 1))).astype(np_dtype)
                 for _ in range(fields))
    if fields == 1:
        z, dual = z[0], dual[0]
    return net, coeffs, colloc.astype(np_dtype), z, dual


def _problem_pair(kind, dtype, **extra):
    if kind == "euler":
        return _euler_strong_problem(dtype, **extra)
    return _burgers_problem(kind == "burgers_visc", dtype, **extra)


def _admm(z, dual, asarray, cls):
    if isinstance(z, tuple):
        return cls(z=tuple(asarray(v) for v in z), dual=tuple(asarray(v) for v in dual))
    return cls(z=asarray(z), dual=asarray(dual))


def _loss_and_grad(kind, dtype, extra, seed):
    """(JAX loss, JAX grads as numpy leaves, port loss, port grads) of the
    training loss at the same params, batch and ADMM state."""
    np_dtype = np.float64 if dtype == "float64" else np.float32
    with jax.enable_x64(dtype == "float64"):
        jp, tp = _problem_pair(kind, dtype, **extra)
        net, coeffs, colloc, z, dual = _inputs(kind, np_dtype, seed, tp.lb, tp.ub)
        admm = tp.exp.loss.residual_kind == "admm"
        jparams = _tree(net, *coeffs, lambda v: jnp.asarray(v, np_dtype))
        jadmm = _admm(z, dual, jnp.asarray, JADMM) if admm else None
        (jl, jaux), jg = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
            jparams, jnp.asarray(colloc), jadmm)
        jleaves = [np.asarray(jg["net"][i][k]) for i in range(len(net)) for k in ("W", "b")]
        jl = float(jl)
    tparams = _tree(net, *coeffs, lambda v: torch.from_numpy(np.asarray(v, np_dtype)))
    tparams = ttrainer.tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    tadmm = _admm(z, dual, torch.from_numpy, ADMMState) if admm else None
    tl_, taux = ttrainer.make_loss_fn(tp)(tparams, torch.from_numpy(colloc), tadmm)
    leaves = net_leaves(tparams["net"])
    tg = [g.detach().numpy() for g in torch.autograd.grad(tl_, leaves)]
    return jl, jleaves, float(tl_.detach()), tg, (jp, tp, net, coeffs, colloc, z, dual)


def _assert_loss_grad(jl, jg, tl_, tg, dtype):
    rtol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(tl_, jl, rtol=rtol)
    for i, (g, w) in enumerate(zip(tg, jg)):
        _close(f"leaf {i}", g.ravel(), w.ravel(), rtol, rtol)


ENTROPY_CASES = [("burgers_visc", "mean_sq", 1), ("burgers_invisc", "mean_sq", 1),
                 ("euler", "mean_sq", 1), ("burgers_visc", "admm", 2), ("euler", "l1_sq_norm", 2),
                 ("euler", "admm", 1)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,residual,mb", ENTROPY_CASES,
                         ids=[f"{k}-{r}-mb{m}" for k, r, m in ENTROPY_CASES])
def test_strong_entropy_loss_and_grad_match_jax(kind, residual, mb, dtype):
    """(c) loss.entropy_weight 0.5 on the strong form: the per-point
    entropy_sq (some points active) and the training loss with its gradient
    against JAX, Burgers viscous and inviscid and Euler, single pass and
    microbatched (the ADMM body and the sums' body)."""
    extra = {"loss.entropy_weight": 0.5, "loss.residual_kind": residual,
             "sampling.microbatch": mb}
    jl, jg, tl_, tg, (jp, tp, net, coeffs, colloc, _, _) = _loss_and_grad(kind, dtype, extra, 51)
    _assert_loss_grad(jl, jg, tl_, tg, dtype)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    with jax.enable_x64(dtype == "float64"):
        jent = np.asarray(jp.entropy_sq(_tree(net, *coeffs, lambda v: jnp.asarray(v, np_dtype)),
                                        jnp.asarray(colloc)))
    tent = tp.entropy_sq(_tree(net, *coeffs, lambda v: torch.from_numpy(np.asarray(v, np_dtype))),
                         torch.from_numpy(colloc)).numpy()
    assert tent.shape == (64, 1) and (tent > 0).any()
    rtol = 1e-5 if dtype == "float32" else 1e-10
    _close("entropy_sq", tent, jent, rtol, rtol)
    # without the penalty the loss is the one of slice 2b-ii
    jl0, _, tl0, _, _ = _loss_and_grad(kind, dtype, dict(extra, **{"loss.entropy_weight": 0.0}),
                                       51)
    np.testing.assert_allclose(tl0, jl0, rtol=rtol)
    if dtype == "float64":  # the penalty's own share, free of float32 cancellation
        assert tl_ != tl0
        np.testing.assert_allclose(tl_ - tl0, jl - jl0, rtol=1e-8)


def test_euler_entropy_production_matches_jax_at_the_clamps():
    """euler_entropy_production and its gradient against JAX's in float64,
    with rows whose rho sits on the clamp (max(rho, 1e-3) at a tie takes
    half the gradient in both)."""
    from pinns_tpu.ops.residuals import euler_entropy_production as jprod

    from pinns_tpu_torch.ops.residuals import euler_entropy_production as tprod

    rng = np.random.default_rng(61)
    y = np.stack([rng.uniform(0.2, 2, 32), rng.uniform(-1, 1, 32), rng.uniform(0.5, 3, 32)],
                 axis=1)
    y[:4, 0] = 1e-3  # rho on the clamp
    y[4:8, 0] = 5e-4  # below it
    y_x, y_t = rng.standard_normal((32, 3)), rng.standard_normal((32, 3))
    cot = rng.standard_normal((32, 1))
    with jax.enable_x64(True):
        jd, jvjp = jax.vjp(lambda a, b, c: jprod(a, b, c, 1.4), jnp.asarray(y), jnp.asarray(y_x),
                           jnp.asarray(y_t))
        jgrads = jvjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in (y, y_x, y_t)]
    td = tprod(*ts, 1.4)
    tgrads = torch.autograd.grad(td, ts, torch.from_numpy(cot))
    _close("D", td.detach().numpy(), np.asarray(jd), 1e-12, 1e-12)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        _close(f"grad {i}", g.numpy(), np.asarray(w), 1e-12, 1e-12)


# -- (d) the weak entropy at fine and coarse cells --------------------------------

WEAK_CASES = [("twosin_weak", True), ("twosin_weak", False), ("euler_weak_fast", True),
              ("euler_weak_fast", False)]


def _weak_problems(preset, viscous):
    if preset == "twosin_weak":
        upd = {"model.layers": BURGERS_NET, "sampling.n_f": 64, "data.n_u": 16,
               "model.dtype": "float64", "pde.lambda2": 0.003 if viscous else 0.0}
    else:
        upd = dict(SMALL, **{"model.dtype": "float64", "pde.lambda2": 1e-3 if viscous else 0.0,
                             "loss.strong_equations": ()})
    jp = jtrainer.build_problem(joverride(JPRESETS[preset], upd))
    tp = ttrainer.build_problem(override(get_preset(preset), upd), "cpu")
    assert tp.viscous_static == jp.viscous_static == viscous
    return jp, tp


@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("preset,viscous", WEAK_CASES,
                         ids=[f"{p}-{'visc' if v else 'invisc'}" for p, v in WEAK_CASES])
def test_weak_entropy_matches_jax(preset, viscous, scale):
    """(d) flux_residuals_and_entropy with the entropy at the configured
    cells and at cells scale times wider, Burgers and Euler, viscous and
    not, against JAX in float64: r, the entropy violation (some cells
    active) and the gradient of a weighted sum of both in the net."""
    with jax.enable_x64(True):
        jp, tp = _weak_problems(preset, viscous)
        if preset == "twosin_weak":
            net = [{k: v.astype(np.float64) for k, v in layer.items()}
                   for layer in numpy_params(BURGERS_NET, 71)]
            coeffs = (0.377, 0.003 if viscous else 0.0)
        else:
            net = [{k: np.asarray(v, np.float64) for k, v in layer.items()}
                   for layer in path_net(seed=72)]
            net[-1]["b"] = np.asarray([[1.0, 0.2, 2.5]])
            coeffs = (1.0, 1e-3 if viscous else 0.0)
        c = _centers(tp.lb, tp.ub, 48, 73)
        rng = np.random.default_rng(74)
        fields = 1 if preset == "twosin_weak" else 3
        cot_r, cot_e = rng.standard_normal((48, fields)), rng.standard_normal((48, 1))

        def jf(p):
            r, ent = jp.flux_residuals_and_entropy(p, jnp.asarray(c), True, scale=scale)
            r = jnp.concatenate(r, axis=1) if isinstance(r, tuple) else r
            return jnp.sum(r * cot_r) + jnp.sum(ent * cot_e), (r, ent)

        (_, (jr, jent)), jg = jax.value_and_grad(jf, has_aux=True)(
            _tree(net, *coeffs, jnp.asarray))
        jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg["net"])]
    tparams = ttrainer.tree_map(lambda t: t.requires_grad_(True),
                                _tree(net, *coeffs, torch.from_numpy))
    r, ent = tp.flux_residuals_and_entropy(tparams, torch.from_numpy(c), True, scale=scale)
    r = torch.cat(r, dim=1) if isinstance(r, tuple) else r
    loss = torch.sum(r * torch.from_numpy(cot_r)) + torch.sum(ent * torch.from_numpy(cot_e))
    # JAX's leaves of a layer dict sort its keys (W, b, path_a, path_c)
    tleaves = [t for layer in tparams["net"] for _, t in sorted(layer.items())]
    tg = torch.autograd.grad(loss, tleaves)
    _close("r", r.detach().numpy(), np.asarray(jr), 1e-9, 1e-12)
    tent = ent.detach().numpy()
    assert (tent > 0).any()
    _close("entropy", tent, np.asarray(jent), 1e-9, 1e-12)
    for i, (g, w) in enumerate(zip(tg, jleaves)):
        _close(f"leaf {i}", g.numpy(), w, 1e-9, 1e-12)
    if scale != 1.0:  # wider cells: another residual
        r1 = tp.flux_residuals_and_entropy(tparams, torch.from_numpy(c), True)[0]
        r1 = torch.cat(r1, dim=1) if isinstance(r1, tuple) else r1
        assert not torch.allclose(r1, r)


@pytest.mark.parametrize("kind,viscous", [("burgers", True), ("burgers", False),
                                          ("euler", True), ("euler", False)])
def test_k7b_entropy_backward_reference_matches_autograd(kind, viscous):
    """K7b's backward with the entropy's cotangent (flux_backward_reference:
    the kernel's formulas) against autograd through the plain quadrature
    with want_entropy, in float64, with rows whose rho sits on the 1e-3
    clamp (half the gradient at a tie, as torch.maximum and JAX)."""
    n, q = 40, 4
    fields = 1 if kind == "burgers" else 3
    rng = np.random.default_rng(81)
    base = np.array([1.0, 0.3, 2.0]) if kind == "euler" else np.zeros(1)
    yv = base + 0.3 * rng.standard_normal((n * 4 * q, fields))
    if kind == "euler":
        yv[:3, 0] = 1e-3  # rho on the clamp in a bottom edge
        yv[2 * q:2 * q + 2, 0] = 1e-3  # and in a left edge
    y = torch.tensor(yv, requires_grad=True)
    yx = torch.tensor(rng.standard_normal((n * 4 * q, fields)), requires_grad=True) \
        if viscous else None
    hxe = torch.tensor(rng.uniform(0.01, 0.02, (n, 1)))
    hte = torch.tensor(rng.uniform(0.005, 0.01, (n, 1)))
    gamma = 1.4
    c0 = torch.tensor([0.37 if kind == "burgers" else gamma - 1.0], dtype=torch.float64,
                      requires_grad=kind == "burgers")
    c1 = torch.tensor([0.003 if kind == "burgers" else 0.0025], dtype=torch.float64,
                      requires_grad=True)
    if kind == "burgers":
        r, ent = twf.burgers_quadrature_reference(y, yx, hxe, hte, c0, c1, q, True)
    else:
        rs, ent = twf.euler_quadrature_reference(y, yx, hxe, hte, gamma, c1, q, True)
        r = torch.cat(rs, dim=1)
    assert 0 < int((ent > 0).sum()) < n
    g_r, g_ent = torch.tensor(rng.standard_normal((n, fields))), torch.tensor(
        rng.standard_normal((n, 1)))
    wrt = [y] + ([yx] if viscous else []) + ([c0, c1] if kind == "burgers" else [c1])
    want = torch.autograd.grad(torch.sum(r * g_r) + torch.sum(ent * g_ent), wrt,
                               allow_unused=True)
    e = torch.sqrt(ent.detach())  # relu(e) is all the adjoint reads of e
    coeffs = torch.cat([c0, c1]).detach()
    gy, gyx, gc = k7b.flux_backward_reference(kind, g_r, y.detach(),
                                              None if yx is None else yx.detach(), hxe, hte,
                                              coeffs, q, g_ent, e, gamma)
    got = [gy] + ([gyx] if viscous else []) + ([gc[0:1], gc[1:2]] if kind == "burgers"
                                               else [gc[1:2]])
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10 * max(float(w.abs().max()), 1e-30),
                                   msg=f"output {i}")


def test_k7b_entropy_wrappers_refuse_cpu_tensors():
    """The entropy mode's wrappers take CUDA tensors only: no fallback."""
    y, h = torch.zeros((64, 1)), torch.ones((4, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7b.flux_quadrature("burgers", y, None, h, h, torch.zeros(2), 4, entropy=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7b.flux_backward("euler", torch.zeros((4, 3)), torch.zeros((64, 3)), None, h, h,
                          torch.zeros(2), 4, g_ent=torch.zeros((4, 1)), e=torch.zeros((4, 1)))


# -- (e) gradient weighting ---------------------------------------------------------

@pytest.mark.parametrize("kappa", [1.0, 10.0])
@pytest.mark.parametrize("kind", ["burgers_visc", "euler"])
def test_gradient_weighting_matches_jax(kind, kappa):
    """(e) loss.grad_weight_kappa on the ADMM loss (float32): the weighted
    residual field, the loss, its gradient (the indicator detached), and
    the ADMM z / dual / misfit after _post_update at the next batch, against
    JAX's."""
    extra = {"loss.grad_weight_kappa": kappa, "loss.residual_kind": "admm"}
    jl, jg, tl_, tg, (jp, tp, net, coeffs, colloc, z, dual) = _loss_and_grad(
        kind, "float32", extra, 91)
    _assert_loss_grad(jl, jg, tl_, tg, "float32")
    jparams = _tree(net, *coeffs, lambda v: jnp.asarray(v, jnp.float32))
    tparams = _tree(net, *coeffs, lambda v: torch.from_numpy(np.asarray(v, np.float32)))
    jf = jp.residuals(jparams, jnp.asarray(colloc))
    tf = tp.residuals(tparams, torch.from_numpy(colloc))
    jf, tf = (jf, tf) if isinstance(jf, tuple) else ((jf,), (tf,))
    plain = ttrainer.build_problem(override(tp.exp, {"loss.grad_weight_kappa": 0.0}), "cpu",
                                   dataset=None if kind == "euler" else GRID)
    for i, (a, b) in enumerate(zip(tf, jf)):
        _close(f"f{i}", a.numpy(), np.asarray(b), 1e-5, 1e-5)
    unweighted = plain.residuals(tparams, torch.from_numpy(colloc))
    unweighted = unweighted if isinstance(unweighted, tuple) else (unweighted,)
    assert all(bool((a.abs() <= b.abs() + 1e-7).all()) and not torch.equal(a, b)
               for a, b in zip(tf, unweighted))
    jadmm = _admm(z, dual, jnp.asarray, JADMM)
    tadmm = _admm(z, dual, torch.from_numpy, ADMMState)
    # JAX draws its next batch from the key: hand the port JAX's draw
    jadmm2, jcolloc, _, jmis = jtrainer._post_update(jp, jparams, jadmm, jnp.asarray(colloc),
                                                     jax.random.key(3), None, 0)
    tadmm2, tcolloc, _, tmis = ttrainer._post_update(
        tp, tparams, tadmm, torch.from_numpy(colloc), 3, None, 0,
        new_colloc=torch.from_numpy(np.asarray(jcolloc)))
    # z and dual come out of f - z and f + dual: held to 1e-5 of the weighted
    # residual's scale, the terms their differences cancel
    scale = max(float(np.abs(np.asarray(b)).max()) for b in jf)
    for name in ("z", "dual"):
        jv, tv = getattr(jadmm2, name), getattr(tadmm2, name)
        jv, tv = (jv, tv) if isinstance(jv, tuple) else ((jv,), (tv,))
        for i, (a, b) in enumerate(zip(tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f"{name}{i}")
    np.testing.assert_allclose(float(tmis), float(jmis), rtol=1e-4)


def test_gradient_weighting_refusals_match_jax():
    """A negative kappa raises as in JAX; kappa on the weak form raises
    (a strong-form pointwise knob)."""
    _, tp = _burgers_problem(True, "float32", **{"loss.grad_weight_kappa": -1.0})
    with pytest.raises(ValueError, match="grad_weight_kappa must be >= 0"):
        ttrainer.make_loss_fn(tp)
    weak = ttrainer.build_problem(override(get_preset("twosin_weak"), {
        "model.layers": BURGERS_NET, "loss.grad_weight_kappa": 1.0}), "cpu")
    params = _tree(numpy_params(BURGERS_NET, 5), 1.0, 0.003, torch.from_numpy)
    with pytest.raises(ValueError, match="strong-form pointwise knob"):
        ttrainer.make_loss_fn(weak)(params, torch.from_numpy(numpy_points(8, 6)), None)
    ttrainer.check_slice(weak.exp)  # the slice takes kappa; the loss refuses the pairing


# -- (f) the coarse-cell selection battery -----------------------------------------

@pytest.mark.parametrize("preset", ["abgrall_admm", "twosin_weak"])
def test_coarse_battery_matches_jax(preset):
    """(f) selection_scores with coarse_scales=(2, 4) at E 3: coarse_r2,
    coarse_ent2, coarse_r4, coarse_ent4 beside the other scores, at JAX's own
    points, against JAX's selection_scores."""
    jtr = _jax_trainer(preset)
    j0 = jens.init_ensemble_states(jtr, SEEDS)
    jst, _ = jens.make_ensemble_chunk(jtr, 3)(j0)
    tree = _jax_tree(jst)
    jscores = jens.selection_scores(jtr, jst, 3, seed=0, n_points=256, coarse_scales=(2, 4))
    spec = jtr.problem.spec
    pts = np.array(juniform_box(jax.random.PRNGKey(0), 256,
                                jnp.asarray(jtr.problem.lb, spec.dtype),
                                jnp.asarray(jtr.problem.ub, spec.dtype), spec.dtype))
    ttr = _ens_trainer(preset)
    tst = ensemble_state_from_jax(tree, CPU, keys=SEEDS)
    tscores = tens.scores_at(ttr, tst, torch.from_numpy(pts), coarse_scales=(2, 4))
    keys = ("coarse_r2", "coarse_ent2", "coarse_r4", "coarse_ent4")
    assert [list(s) for s in tscores] == [list(s) for s in jscores]
    for t, j in zip(tscores, jscores):
        for key in ("data_term", "resid_ms", "score") + keys:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-7 * abs(j["score"]),
                                       err_msg=key)
    assert any(s["coarse_ent2"] > 0 for s in tscores)
    own = tens.selection_scores(ttr, tst, 3, seed=0, n_points=128, coarse_scales=(2,))
    assert all(math.isfinite(s["coarse_r2"]) and "coarse_r4" not in s for s in own)
