"""Port parity for the L-BFGS phase: ``opt/lbfgs.py`` against the JAX
package's ``lbfgs_minimize`` in float64, against SciPy, and
``train.trainer.make_lbfgs_step`` against JAX's at fixed inputs.

In float64 both solvers take the same branches, so the iterates agree to
rounding: x within 1e-9 of max|x| (the dot products sum in other orders), and
n_iters, n_evals and converged equal. The L-BFGS step's metrics, params and
z/dual are held to the same 1e-9, relative to each quantity's scale.
"""

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
from pinns_tpu.opt.lbfgs import lbfgs_minimize as jax_lbfgs
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import train_state_from_jax
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import numpy_params, numpy_points

GRID = "tests/fixtures/torch_port/twosin_burgers_shock.npz"
NET = (2, 10, 10, 10, 1)  # 3x10
N_F, N_U = 48, 16
X_RTOL = 1e-9
LBFGS = dict(history=50, ftol=1e-12, gtol=1e-7, max_ls=50)  # LBFGSConfig's defaults
_SOLVERS = {}  # problem -> (jitted JAX solve, port fun, x0): one JAX compile each


def _updates(**extra):
    return {"model.layers": NET, "sampling.n_f": N_F, "data.n_u": N_U,
            "pde.lambda2": 0.01 / math.pi, "optimizer.kind": "lbfgs",
            "model.dtype": "float64", **extra}


def _jax_problem(updates, dtype):
    exp = joverride(JPRESETS["abgrall_admm"], updates)
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub), dtype=dtype)
    return jtrainer.Problem(exp=exp, dataset=ds, spec=spec,
                            x_data=jnp.asarray(x_data, dtype),
                            targets={k: jnp.asarray(v, dtype) for k, v in targets.items()})


def _inputs(seed=71):
    rng = np.random.default_rng(seed)
    return {"net": [{k: v.astype(np.float64) for k, v in layer.items()}
                    for layer in numpy_params(NET, seed)],
            "colloc": numpy_points(N_F, seed + 1).astype(np.float64),
            "z": 0.1 * rng.standard_normal((N_F, 1)),
            "dual": 1.0 + 0.1 * rng.standard_normal((N_F, 1))}


def _params(net, lam1, lam2, asarray):
    return {"net": [{k: asarray(v) for k, v in layer.items()} for layer in net],
            "coeffs": {"lambda1": asarray(np.full((1,), lam1)),
                       "lambda2": asarray(np.full((1,), lam2))}}


def _problem(name):
    """(JAX fun, port fun, x0) of one test problem, all in float64."""
    if name == "quadratic":
        a = np.array([1.0, 10.0, 100.0, 3.0, 0.5, 30.0])
        b = np.array([1.0, -2.0, 0.5, 4.0, -1.0, 0.25])
        return (lambda x: 0.5 * jnp.sum(jnp.asarray(a) * (x - jnp.asarray(b)) ** 2),
                lambda x: 0.5 * torch.sum(torch.from_numpy(a) * (x - torch.from_numpy(b)) ** 2),
                np.zeros(6))
    if name == "rosenbrock":
        return (lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
                lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
                np.array([-1.2, 1.0, -1.2, 1.0, 0.5]))
    # the abgrall_admm loss at a 3x10 net, the state from numpy
    upd = _updates()
    inp = _inputs()
    lam1, lam2 = 1.0, 0.01 / math.pi
    jp = _jax_problem(upd, jnp.float64)
    jloss = jtrainer.make_loss_fn(jp)
    jadmm = JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"]))
    x0, unravel = ravel_pytree(_params(inp["net"], lam1, lam2, jnp.asarray))
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), upd), "cpu", dataset=GRID)
    tloss = ttrainer.make_loss_fn(tp)
    tadmm = ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"]))
    _, tunravel = tl.ravel_tree(_params(inp["net"], lam1, lam2, torch.from_numpy))
    colloc = inp["colloc"]
    return (lambda x: jloss(unravel(x), jnp.asarray(colloc), jadmm)[0],
            lambda x: tloss(tunravel(x), torch.from_numpy(colloc), tadmm)[0],
            np.asarray(x0))


def _solvers(name):
    if name not in _SOLVERS:
        with jax.enable_x64(True):
            jfun, tfun, x0 = _problem(name)
            solve = jax.jit(lambda x, iters: jax_lbfgs(jfun, x, max_iters=iters, **LBFGS))
        _SOLVERS[name] = (solve, tfun, x0)
    return _SOLVERS[name]


@pytest.mark.parametrize("max_iters", [1, 2, 5, 20])
@pytest.mark.parametrize("name", ["quadratic", "rosenbrock", "abgrall_admm_3x10"])
def test_lbfgs_matches_jax_float64(name, max_iters):
    solve, tfun, x0 = _solvers(name)
    with jax.enable_x64(True):
        want = solve(jnp.asarray(x0), max_iters)
        want_x = np.asarray(want.x)
    got = tl.lbfgs_minimize(tfun, torch.tensor(x0), max_iters=max_iters, **LBFGS)
    assert got.x.dtype == torch.float64
    assert (got.n_iters, got.n_evals, got.converged) == (
        int(want.n_iters), int(want.n_evals), bool(want.converged))
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=0,
                               atol=X_RTOL * np.abs(want_x).max())
    np.testing.assert_allclose(float(got.f), float(want.f), rtol=1e-12)


def test_lbfgs_matches_scipy_on_logsumexp():
    """The final objective against SciPy's L-BFGS-B on a smooth convex
    function, as tests/test_lbfgs.py holds the JAX solver."""
    import scipy.optimize

    rng = np.random.default_rng(0)
    a = rng.standard_normal((20, 8))
    b = rng.standard_normal(20)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    res = tl.lbfgs_minimize(
        lambda x: torch.logsumexp(at @ x - bt, 0) + 0.01 * torch.sum(x * x),
        torch.zeros(8, dtype=torch.float64), max_iters=200, **LBFGS)

    def fun_np(x):
        z = a @ x - b
        m = z.max()
        return m + np.log(np.exp(z - m).sum()) + 0.01 * (x * x).sum()

    sp = scipy.optimize.minimize(fun_np, np.zeros(8), method="L-BFGS-B")
    assert abs(float(res.f) - sp.fun) < 1e-8
    assert res.converged


def test_lbfgs_float32_and_edge_cases():
    """float32 stays float32; an already-converged start takes no step; the
    pytree front-end flattens in ravel_pytree's order (sorted dict keys)."""
    res = tl.lbfgs_minimize(lambda x: torch.sum(x * x), torch.zeros(3), max_iters=10)
    assert res.converged and res.n_iters == 0 and res.n_evals == 1
    res = tl.lbfgs_minimize(lambda x: torch.sum((x - 2.0) ** 2), torch.zeros(4), max_iters=50)
    assert res.x.dtype == torch.float32 and res.converged
    np.testing.assert_allclose(res.x.numpy(), 2.0, atol=1e-5)
    params = {"w": torch.zeros(3, 2), "b": torch.zeros(5)}
    flat, unravel = tl.ravel_tree({"w": torch.arange(6.0).view(3, 2), "b": -torch.ones(5)})
    np.testing.assert_array_equal(flat.numpy(), [-1.0] * 5 + list(range(6)))
    assert list(unravel(flat)) == ["w", "b"]
    out, res = tl.lbfgs_minimize_pytree(
        lambda p: torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2), params,
        max_iters=50)
    np.testing.assert_allclose(out["w"].numpy(), 3.0, atol=1e-4)
    np.testing.assert_allclose(out["b"].numpy(), -1.0, atol=1e-4)


def test_lbfgs_step_matches_jax():
    """make_lbfgs_step vs JAX's at the same params, batch and ADMM state, in
    float64 with max_iters 4; the port's tail is fed JAX's resampled points."""
    upd = _updates(**{"optimizer.lbfgs.max_iters": 4})
    inp = _inputs(seed=73)
    lam1, lam2 = 1.0, 0.01 / math.pi
    with jax.enable_x64(True):
        jp = _jax_problem(upd, jnp.float64)
        params = _params(inp["net"], lam1, lam2, jnp.asarray)
        jstate = jtrainer.TrainState(
            params=params, opt_state=None,
            admm=JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"])),
            colloc=jnp.asarray(inp["colloc"]), key=jax.random.key(5),
            epoch=jnp.zeros((), jnp.int32))
        jstate, jm = jax.jit(jtrainer.make_lbfgs_step(jp))(jstate)
        jm = {k: float(v) for k, v in jm.items()}
        want = {"params": ravel_pytree(jstate.params)[0], "z": jstate.admm.z,
                "dual": jstate.admm.dual, "colloc": jstate.colloc}
        want = {k: np.array(v) for k, v in want.items()}
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), upd), "cpu", dataset=GRID)
    tree = {"params": _params(inp["net"], lam1, lam2, np.asarray), "count": 0,
            "mu": _params(inp["net"], 0.0, 0.0, np.zeros_like),
            "nu": _params(inp["net"], 0.0, 0.0, np.zeros_like), "colloc": inp["colloc"],
            "z": inp["z"], "dual": inp["dual"], "epoch": 0, "key": 5}
    tstate = train_state_from_jax(tree, torch.device("cpu"))
    tstate, tm = ttrainer.make_lbfgs_step(tp)(tstate, new_colloc=torch.from_numpy(want["colloc"]))
    assert sorted(tm) == sorted(jm) and tstate.epoch == 1
    assert float(tm["lbfgs_iters"]) == jm["lbfgs_iters"] == 4.0
    for k in jm:  # the metric row is float32, as JAX's chunk packs it
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-6, atol=1e-7 * abs(jm["loss"]),
                                   err_msg=k)
    got = tl.ravel_tree(tstate.params)[0].numpy()
    np.testing.assert_allclose(got, want["params"], rtol=0,
                               atol=X_RTOL * np.abs(want["params"]).max())
    for k in ("z", "dual"):
        g = getattr(tstate.admm, k).numpy()
        np.testing.assert_allclose(g, want[k], rtol=0, atol=X_RTOL * np.abs(want[k]).max(),
                                   err_msg=k)
