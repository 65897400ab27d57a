"""K10's solve as one launch of a conditional WHILE node (``ops/kernels/
lbfgs.py::SolveLoop``), held on the CPU:

(a) the loop's plain drive (``loop_reference``: body iterations of k steps
    while the condition holds, the control's plain version setting it to 0
    where the kernel does) against the stepwise drive (``run_steps``, the
    done flag read every 1 and every 16 steps), on a quadratic (autograd's
    evaluation) and on the 3x16 ADMM problem (K3's value-and-grad): every
    buffer, n_evals and the branches word bit for bit, at most k - 1
    steps after the end, and the control step counter (``Buffers.steps``,
    the device's count of the steps a loop ran) equal to the steps each
    drive ran;
(b) the evaluation the card captures (``AutogradLBFGS``'s, autograd through
    the trainer's loss) on the loop's plain drive, against JAX's
    ``lbfgs_minimize`` at max_iters 1, 2 and 5 for the three families that
    take it: a narrow Euler weak-form net with two shock paths, burgers_inverse
    at 8x20 on a small batch (float32), and polish's float64 loss at 3x16
    (against ``lbfgs_minimize_pytree`` under x64): equal n_iters and n_evals,
    x and f within chip_smoke.py's phase-13 / phase-39 step tolerance (1% of
    JAX's largest step plus 1e-6 of the value; 1e-10 in float64);
(c) a no-host-read guard: each family's evaluation with ``Tensor.item``,
    ``.cpu``, ``.numpy``, ``.tolist``, ``__bool__``, ``__float__`` and
    ``__int__`` made to raise, since a host read inside a captured evaluation
    would bake the first evaluation's value into the graph; and the
    evaluation reads the trial point's contents anew each time (no cache
    keyed on the buffer it lives in).

Inputs come from numpy with a seed; the JAX solves are computed once a
family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinns_tpu.opt.lbfgs import lbfgs_minimize as jax_lbfgs
from pinns_tpu.opt.lbfgs import lbfgs_minimize_pytree as jax_lbfgs_pytree
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.train import trainer as ttrainer
from pinns_tpu_torch.train.polish import FTOL, GTOL
from test_torch_lbfgs_device import PROBLEMS, STEP_TOL, ULP_TOL, _admm_problem, _euler_problem
from test_torch_polish import _params
from torch_port_util import no_host_reads

ITERS = (1, 2, 5)
F64_TOL = 1e-10  # float64 iterates: the sums run in other orders
_CACHE = {}


# -- (a) the loop's plain drive against the stepwise drive ----------------------------

def _quadratic_drive():
    _, fun, x0 = PROBLEMS["quadratic"]
    solver = k_lbfgs.AutogradLBFGS()

    def make(b):
        solver.bufs = b
        return lambda: solver._evaluate(fun)

    return make, torch.from_numpy(x0), 20


def _admm_drive():
    _, tp, params, colloc, admm, _ = _admm_problem()
    x0, _ = tl.ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    cfg = k_fused.loss_config(tp.exp)
    u = tp.targets["u"].contiguous()

    def make(b):
        return lambda: k_fused.fused_value_and_grad(
            tp.spec, b.vec[k_lbfgs.XT, off:], b.vec[k_lbfgs.GT, off:],
            b.sf[k_lbfgs.F_PHI_T:k_lbfgs.F_PHI_T + 1], tp.x_data, u, colloc, admm.z, admm.dual,
            rho=10.0, skip=b.si[:1], **cfg)

    return make, x0, 20


DRIVES = {"quadratic": _quadratic_drive, "abgrall_admm_3x16": _admm_drive}


def _drive(name, how, k):
    """The buffers and result of one solve from x0 on ``how``'s drive, and
    the evaluations it ran."""
    make, x0, max_iters = DRIVES[name]()
    b = k_lbfgs.Buffers.alloc(x0.numel(), 50, "cpu")
    evaluate = make(b)
    calls = [0]

    def counted():
        calls[0] += 1
        evaluate()

    k_lbfgs.reset(b, x0, max_iters=max_iters)
    if how == "loop":
        k_lbfgs.loop_reference(b, counted, k)
        res = k_lbfgs.result(b, k_lbfgs.read_head(b))
    else:
        res = k_lbfgs.run_steps(b, counted, k)
    return b, res, calls[0]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("name", sorted(DRIVES))
def test_loop_plain_drive_equals_the_stepwise_drive(name, k):
    loop, got, calls = _drive(name, "loop", k)
    assert got.n_iters > 2 and calls == k * -(-got.n_evals // k)  # k - 1 steps after the end
    assert int(loop.steps) == calls
    for sync_every in (1, 16):
        b, want, b_calls = _drive(name, "steps", sync_every)
        assert int(b.steps) == b_calls == sync_every * -(-want.n_evals // sync_every)
        assert (got.n_iters, got.n_evals, got.converged) == (want.n_iters, want.n_evals,
                                                              want.converged)
        assert all(torch.equal(u, v) for u, v in zip(loop.tensors(), b.tensors()))
        assert int(loop.si[k_lbfgs.I_BRANCHES]) == int(b.si[k_lbfgs.I_BRANCHES])


def test_control_plain_version_ends_the_loop():
    """The condition goes to 0 in the control step that sets the done flag
    and stays 0 on a done state; the state's bits do not depend on it."""
    _, fun, x0 = PROBLEMS["quadratic"]
    solver = k_lbfgs.AutogradLBFGS()
    b = solver.bufs = k_lbfgs.Buffers.alloc(6, 50, "cpu")
    k_lbfgs.reset(b, torch.from_numpy(x0), max_iters=1)
    cond, steps = [1], 0
    while not int(b.si[k_lbfgs.I_DONE]):
        solver._evaluate(fun)
        twin = b.clone()
        k_lbfgs.control_reference(b, cond)
        k_lbfgs.control_reference(twin)
        assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))
        assert cond[0] == (0 if int(b.si[k_lbfgs.I_DONE]) else 1)
        k_lbfgs.direction_reference(b)
        steps += 1
    cond = [1]
    k_lbfgs.control_reference(b, cond)
    assert cond == [0] and steps == int(b.si[k_lbfgs.I_EVALS])
    assert int(b.steps) == steps + 1  # the step after the end is counted too


# -- (b) the captured evaluation's families against JAX --------------------------------

def _euler_family():
    solve, fun, x0 = _euler_problem()
    want = {k: solve(jnp.asarray(x0.numpy()), k) for k in ITERS}
    return fun, x0, {}, want, np.float32


def _burgers(name, layers, n_f, n_u, dtype, seed):
    """JAX's and the port's problem of a Burgers preset at ``layers`` on the
    committed grid, and numpy inputs: the net, the preset's coefficients at
    their start, a batch of ``n_f`` points (JAX's problem in ``dtype``)."""
    import test_torch_polish as tp_mod
    from pinns_tpu.config import override as joverride
    from pinns_tpu.data import datasets as jds
    from pinns_tpu.experiments.presets import PRESETS as JPRESETS
    from pinns_tpu.models.mlp import MLPSpec as JSpec
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from torch_port_util import numpy_params, numpy_points

    upd = {"model.layers": layers, "sampling.n_f": n_f, "data.n_u": n_u,
           "model.dtype": np.dtype(dtype).name}
    exp = joverride(JPRESETS[name], upd)
    with np.load(tp_mod.GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    build = (jds.interior_training_set if exp.data.selection == "interior"
             else jds.build_ic_bc_training_set)
    x_data, targets = build(ds, exp.data.n_u, seed=exp.data.seed, noise=exp.data.noise)
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    spec = JSpec(layers=layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub), dtype=jd)
    jp = jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data, jd),
                          targets={k: jnp.asarray(v, jd) for k, v in targets.items()})
    tp = ttrainer.build_problem(override(get_preset(name), upd), "cpu", dataset=tp_mod.GRID)
    inp = {"net": [{k: v.astype(dtype) for k, v in layer.items()}
                   for layer in numpy_params(layers, seed)],
           "lam": (float(exp.pde.lambda1), float(exp.pde.lambda2)),
           "colloc": numpy_points(n_f, seed + 1).astype(dtype)}
    return jp, tp, inp


def _port_fun(tp, inp, dtype):
    params = _params(inp, lambda v: torch.from_numpy(np.asarray(v, dtype)))
    loss_fn = ttrainer.make_loss_fn(tp)
    x0, unravel = tl.ravel_tree(params)
    colloc = torch.from_numpy(inp["colloc"])
    return (lambda x: loss_fn(unravel(x), colloc, None)[0]), x0


def _inverse_family():
    """burgers_inverse at 8x20 on 128 collocation points and 100 data points,
    float32: the trainable lambda1 and the exp-transformed lambda2."""
    jp, tp, inp = _burgers("burgers_inverse", (2,) + (20,) * 8 + (1,), 128, 100, np.float32, 91)
    jloss = jtrainer.make_loss_fn(jp)
    jcolloc = jnp.asarray(inp["colloc"])
    jx0, junravel = ravel_pytree(_params(inp, lambda v: jnp.asarray(v, jnp.float32)))
    solve = jax.jit(lambda x, iters: jax_lbfgs(lambda y: jloss(junravel(y), jcolloc, None)[0],
                                               x, max_iters=iters))
    want = {k: solve(jx0, k) for k in ITERS}
    fun, x0 = _port_fun(tp, inp, np.float32)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    return fun, x0, {}, want, np.float32


def _polish_family():
    """polish's float64 loss (burgers_forward) at 3x16 against
    lbfgs_minimize_pytree under x64, at polish's tolerances."""
    with jax.enable_x64(True):
        jp, tp, inp = _burgers("burgers_forward", (2, 16, 16, 16, 1), 64, 64, np.float64, 93)
        jloss = jtrainer.make_loss_fn(jp)
        jcolloc = jnp.asarray(inp["colloc"])
        opts = dict(history=jp.exp.optimizer.lbfgs.history, ftol=FTOL, gtol=GTOL)
        solve = jax.jit(lambda p, iters: jax_lbfgs_pytree(
            lambda q: jloss(q, jcolloc, None)[0], p, max_iters=iters, **opts))
        want = {}
        for k in ITERS:
            jparams, res = solve(_params(inp, jnp.asarray), k)
            want[k] = res._replace(x=np.asarray(ravel_pytree(jparams)[0]))
    fun, x0 = _port_fun(tp, inp, np.float64)
    return fun, x0, dict(ftol=FTOL, gtol=GTOL), want, np.float64


FAMILIES = {"euler_weak_paths": _euler_family, "burgers_inverse": _inverse_family,
            "polish_f64": _polish_family}


def _family(name):
    if name not in _CACHE:
        _CACHE[name] = FAMILIES[name]()
    return _CACHE[name]


def _within(got, want, start, tol):
    """|got - want| <= tol * max|want - start| + tol_ulp * max|want|."""
    got, want, start = (np.asarray(v, np.float64) for v in (got, want, start))
    ulp = ULP_TOL if tol == STEP_TOL else F64_TOL
    bound = tol * float(np.abs(want - start).max()) + ulp * float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= bound, (float(np.abs(got - want).max()), bound)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_captured_evaluation_matches_jax(name):
    fun, x0, opts, want, dtype = _family(name)
    tol = STEP_TOL if dtype == np.float32 else F64_TOL
    solver = k_lbfgs.AutogradLBFGS()
    assert solver.captured
    f0 = float(fun(x0).detach())
    for k in ITERS:
        got = solver.minimize(fun, x0, max_iters=k, **opts)
        w = want[k]
        assert got.x.dtype == x0.dtype
        assert (got.n_iters, got.n_evals) == (int(w.n_iters), int(w.n_evals)), (k, got)
        ok, why = _within(got.x.numpy(), np.asarray(w.x), x0.numpy(), tol)
        assert ok, (k, "x", why)
        ok, why = _within(float(got.f), float(w.f), f0, tol)
        assert ok, (k, "f", why)


# -- (c) the no-host-read guard ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_captured_evaluation_reads_nothing_to_the_host(name):
    fun, x0, _, _, _ = _family(name)
    solver = k_lbfgs.AutogradLBFGS()
    solver.minimize(fun, x0, max_iters=1)  # the buffers
    b = solver.bufs
    k_lbfgs.reset(b, x0, max_iters=5)
    with no_host_reads():
        solver._evaluate(fun)
        with pytest.raises(AssertionError, match="host read"):
            b.si[0].item()
    first = (b.sf[k_lbfgs.F_PHI_T].clone(), b.vec[k_lbfgs.GT].clone())
    # the same buffer, other contents: the evaluation reads them anew
    rng = np.random.default_rng(5)
    x1 = x0 + torch.from_numpy(1e-2 * rng.standard_normal(x0.numel())).to(x0.dtype)
    b.vec[k_lbfgs.XT].copy_(x1)
    with no_host_reads():
        solver._evaluate(fun)
    fresh = k_lbfgs.AutogradLBFGS()
    fresh.minimize(fun, x0, max_iters=1)
    k_lbfgs.reset(fresh.bufs, x1.contiguous(), max_iters=5)
    fresh._evaluate(fun)
    assert torch.equal(b.sf[k_lbfgs.F_PHI_T], fresh.bufs.sf[k_lbfgs.F_PHI_T])
    assert torch.equal(b.vec[k_lbfgs.GT], fresh.bufs.vec[k_lbfgs.GT])
    assert not torch.equal(first[1], b.vec[k_lbfgs.GT])
    assert torch.isfinite(first[0]) and torch.isfinite(first[1]).all()


# -- (d) the shard: the loop refused by configuration --------------------------------

def test_shard_takes_the_replay_by_configuration():
    """Under data parallelism (``problem.shard``) NCCL's all-reduce cannot
    sit in a WHILE node's body: DeviceLBFGS's solve is a SolveReplay (16
    steps replayed, the flag read after each) and AutogradLBFGS names the
    refusal, chosen from the configuration; a one-rank shard with no
    process group gives the same bits as no shard."""
    import dataclasses

    from pinns_tpu_torch.parallel.sharding import DataShard

    _, tp, params, colloc, admm, _ = _admm_problem()
    flat, _ = tl.ravel_tree(params)
    sharded = dataclasses.replace(tp, shard=DataShard(rank=0, size=1))
    assert k_lbfgs.autograd_capture_refusals(tp) == []
    assert "data parallelism" in k_lbfgs.autograd_capture_refusals(sharded)[0]
    got = {}
    for name, problem in (("solo", tp), ("shard", sharded)):
        solver = k_lbfgs.DeviceLBFGS(problem)
        got[name] = solver.minimize(flat, k_lbfgs.net_offset(params), colloc, admm, 10.0,
                                    max_iters=5)
        loop = solver.solve_loop(10.0)
        assert type(loop) is (k_lbfgs.SolveLoop if name == "solo" else k_lbfgs.SolveReplay)
        assert loop.steps == (k_lbfgs.DEVICE_STEPS if name == "solo" else k_lbfgs.SYNC_EVERY)
    assert torch.equal(got["solo"].x, got["shard"].x)
    assert (got["solo"].n_iters, got["solo"].n_evals) == (got["shard"].n_iters,
                                                          got["shard"].n_evals)
