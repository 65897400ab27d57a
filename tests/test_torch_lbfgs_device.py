"""K10, the L-BFGS solve on the device (``ops/kernels/lbfgs.py``), on the CPU:
the plain versions of its kernels, stepped evaluation by evaluation as the
card runs them, against the JAX package's float32 ``lbfgs_minimize`` and
against the port's host loop (``opt/lbfgs.py``).

The tolerances: n_iters and n_evals equal, x within chip_smoke.py's phase-13
bound (1% of the largest step JAX took plus 1e-6 of max|x|: the two sum
their dot products and the loss in other orders, float32). The two-loop
direction within 1e-5 of max|d| (float32 sums of 2 count dot products in
other orders). K3's value-and-grad within rtol 1e-5 on the loss and 1e-5 of
each leaf's max|g| on the gradient (its hand-written reverse mode against
autograd, float32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.opt.lbfgs import _two_loop_direction as jax_two_loop
from pinns_tpu.opt.lbfgs import lbfgs_minimize as jax_lbfgs
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import PRESETS, get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.ops.kernels.fused_step import unpack_params
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.train import trainer as ttrainer
from test_torch_lbfgs import GRID, _jax_problem, _params
from torch_port_util import numpy_params, numpy_points

NET = (2, 16, 16, 16, 1)  # 3x16
N_F, N_U = 64, 16
LAM1, LAM2 = 1.0, 0.01 / math.pi
STEP_TOL, ULP_TOL = 1e-2, 1e-6  # chip_smoke.py: ITERATE_STEP_TOL, ITERATE_ULP_TOL
LBFGS_FIXTURE = "tests/fixtures/torch_port/lbfgs_hybrid.npz"
STEPS_FIXTURE = "tests/fixtures/torch_port/abgrall_admm_steps.npz"
_CACHE = {}


def _iterate_bound(want, x0):
    want = np.asarray(want, np.float64)
    return STEP_TOL * float(np.abs(want - np.asarray(x0, np.float64)).max()) \
        + ULP_TOL * float(np.abs(want).max())


def _assert_iterates(got, want, x0):
    err = float(np.abs(got.x.numpy().astype(np.float64) - np.asarray(want.x, np.float64)).max())
    assert (got.n_iters, got.n_evals) == (int(want.n_iters), int(want.n_evals))
    assert err <= _iterate_bound(want.x, x0), (err, _iterate_bound(want.x, x0))


def _admm_updates():
    return {"model.layers": NET, "sampling.n_f": N_F, "data.n_u": N_U, "pde.lambda2": LAM2,
            "optimizer.kind": "lbfgs"}


def _admm_inputs(seed=71):
    rng = np.random.default_rng(seed)
    return {"net": numpy_params(NET, seed), "colloc": numpy_points(N_F, seed + 1),
            "z": (0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
            "dual": (1.0 + 0.1 * rng.standard_normal((N_F, 1))).astype(np.float32)}


def _admm_problem():
    """The abgrall_admm loss at a 3x16 net, float32: (JAX solve, the port's
    problem, its params, batch and ADMM state, x0)."""
    if "admm" not in _CACHE:
        inp = _admm_inputs()
        jp = _jax_problem(_admm_updates(), jnp.float32)
        jloss = jtrainer.make_loss_fn(jp)
        jadmm = JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"]))
        jx0, unravel = ravel_pytree(_params(inp["net"], LAM1, LAM2,
                                            lambda v: jnp.asarray(v, jnp.float32)))
        colloc = jnp.asarray(inp["colloc"])
        solve = jax.jit(lambda x, iters: jax_lbfgs(
            lambda y: jloss(unravel(y), colloc, jadmm)[0], x, max_iters=iters))
        tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), _admm_updates()), "cpu",
                                    dataset=GRID)
        params = _params(inp["net"], LAM1, LAM2,
                         lambda v: torch.from_numpy(np.asarray(v, np.float32)))
        admm = ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"]))
        _CACHE["admm"] = (solve, tp, params, torch.from_numpy(inp["colloc"]), admm,
                          np.asarray(jx0))
    return _CACHE["admm"]


_A = np.array([1.0, 10.0, 100.0, 3.0, 0.5, 30.0], np.float32)
_B = np.array([1.0, -2.0, 0.5, 4.0, -1.0, 0.25], np.float32)
PROBLEMS = {
    "quadratic": (lambda x: 0.5 * jnp.sum(jnp.asarray(_A) * (x - jnp.asarray(_B)) ** 2),
                  lambda x: 0.5 * torch.sum(torch.from_numpy(_A) * (x - torch.from_numpy(_B)) ** 2),
                  np.zeros(6, np.float32)),
    "rosenbrock": (lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
                   lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
                   np.array([-1.2, 1.0, -1.2, 1.0, 0.5], np.float32)),
}


def _euler_problem():
    """euler_weak_tail's loss (weak form, the strong mass residual, two shock
    paths) at a 2x16 path net, N_f 64, float32: (JAX solve, port loss of the
    flat params, x0)."""
    if "euler" not in _CACHE:
        from pinns_tpu.config import override as joverride
        from pinns_tpu.experiments.presets import PRESETS as JPRESETS
        from test_torch_paths import TRUNK, path_net

        upd = {"model.layers": TRUNK, "sampling.n_f": 64, "data.n_u": 64}
        jp = jtrainer.build_problem(joverride(JPRESETS["euler_weak_tail"], upd))
        tp = ttrainer.build_problem(override(get_preset("euler_weak_tail"), upd), "cpu")
        net = path_net(seed=41)
        rng = np.random.default_rng(42)
        c = np.stack([rng.uniform(tp.lb[i], tp.ub[i], 64) for i in range(2)],
                     axis=1).astype(np.float32)
        coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.full(1, 1e-3, np.float32)}
        jparams = {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net],
                   "coeffs": {k: jnp.asarray(v) for k, v in coeffs.items()}}
        jx0, junravel = ravel_pytree(jparams)
        jloss = jtrainer.make_loss_fn(jp)
        colloc = jnp.asarray(c)
        solve = jax.jit(lambda x, iters: jax_lbfgs(
            lambda y: jloss(junravel(y), colloc, None)[0], x, max_iters=iters))
        tparams = {"net": [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in net],
                   "coeffs": {k: torch.from_numpy(v) for k, v in coeffs.items()}}
        flat, unravel = tl.ravel_tree(tparams)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jx0))  # ravel_pytree's order
        tloss = ttrainer.make_loss_fn(tp)
        tc = torch.from_numpy(c)
        _CACHE["euler"] = (solve, lambda x: tloss(unravel(x), tc, None)[0], flat)
    return _CACHE["euler"]


@pytest.mark.parametrize("max_iters", [1, 2, 5, 20])
@pytest.mark.parametrize("name", ["quadratic", "rosenbrock", "abgrall_admm_3x16",
                                  "euler_weak_small"])
def test_k10_plain_matches_jax_float32(name, max_iters):
    """(a) K10's plain state machine against JAX's float32 solve and the
    port's host loop: equal n_iters and n_evals, x within phase 13's bound.
    The 3x16 ADMM loss runs as the card runs it: DeviceLBFGS over K3's
    value-and-grad (its plain version here). euler_weak_small runs the
    solver the card takes for euler_weak_tail: AutogradLBFGS, autograd
    through the Euler path loss as the evaluation; reading the done flag
    after every step instead of every 16 gives the same buffers bit for bit
    (the evaluations after the end leave the state as it was)."""
    if name == "euler_weak_small":
        solve, fun, x0_t = _euler_problem()
        x0 = x0_t.numpy()
        want = solve(jnp.asarray(x0), max_iters)
        solver = k_lbfgs.AutogradLBFGS()
        got = solver.minimize(fun, x0_t, max_iters=max_iters)
        host = tl.lbfgs_minimize(fun, x0_t, max_iters=max_iters)
        each = k_lbfgs.AutogradLBFGS(sync_every=1)
        each.minimize(fun, x0_t, max_iters=max_iters)
        assert all(torch.equal(a, b) for a, b in zip(solver.bufs.tensors(), each.bufs.tensors()))
    elif name == "abgrall_admm_3x16":
        solve, tp, params, colloc, admm, x0 = _admm_problem()
        want = solve(jnp.asarray(x0), max_iters)
        flat, unravel = tl.ravel_tree(params)
        got = k_lbfgs.DeviceLBFGS(tp).minimize(flat, k_lbfgs.net_offset(params), colloc,
                                               admm, 10.0, max_iters=max_iters)
        loss = ttrainer.make_loss_fn(tp)
        host = tl.lbfgs_minimize(lambda x: loss(unravel(x), colloc, admm)[0], flat,
                                 max_iters=max_iters)
    else:
        jfun, tfun, x0 = PROBLEMS[name]
        want = jax_lbfgs(jfun, jnp.asarray(x0), max_iters=max_iters)
        got = k_lbfgs.AutogradLBFGS().minimize(tfun, torch.from_numpy(x0), max_iters=max_iters)
        host = tl.lbfgs_minimize(tfun, torch.from_numpy(x0), max_iters=max_iters)
    assert got.x.dtype == torch.float32 and got.converged == bool(want.converged)
    _assert_iterates(got, want, x0)
    _assert_iterates(got, host, x0)


def test_k10_plain_from_the_fixture_state():
    """(a) at abgrall_admm's full width: DeviceLBFGS's plain path from the
    state of the committed JAX fixture (lbfgs_hybrid.npz, 8x20, N_f 1,000)
    reaches JAX's n_iters and n_evals at 1, 2 and 5 iterations, x within
    phase 13's bound; two solves agree bit for bit."""
    with np.load(STEPS_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    with np.load(LBFGS_FIXTURE) as z:
        lb = {k: z[k] for k in z.files}
    k = int(lb["replay_step"])
    problem = ttrainer.build_problem(get_preset("abgrall_admm"), "cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    params = {"net": unpack_params(t(fx[f"params_{k}"]), problem.spec.layers),
              "coeffs": {"lambda1": torch.full((1,), float(fx["lambda1"])),
                         "lambda2": torch.full((1,), float(fx["lambda2"]))}}
    admm = ADMMState(z=t(fx[f"z_{k}"]), dual=t(fx[f"dual_{k}"]))
    x0, _ = tl.ravel_tree(params)
    assert np.array_equal(x0.numpy(), lb["x0"])
    solver = k_lbfgs.DeviceLBFGS(problem)
    off = k_lbfgs.net_offset(params)
    for iters in (1, 2, 5):
        res = solver.minimize(x0, off, t(fx[f"colloc_{k}"]), admm, 10.0, max_iters=iters)
        want = lb[f"x_{iters}"]
        err = float(np.abs(res.x.numpy().astype(np.float64) - want).max())
        assert err <= _iterate_bound(want, lb["x0"]), (iters, err)
        assert (res.n_iters, res.n_evals) == (int(lb[f"n_iters_{iters}"]),
                                              int(lb[f"n_evals_{iters}"]))
        np.testing.assert_allclose(float(res.f), float(lb[f"f_{iters}"]), rtol=1e-4)
    again = solver.minimize(x0, off, t(fx[f"colloc_{k}"]), admm, 10.0, max_iters=5)
    assert torch.equal(again.x, res.x) and torch.equal(again.f, res.f)


def _history(n, m, count, head, seed):
    """A circular (s, y, rho) history of ``count`` valid pairs ending before
    ``head``, with y = A s for a fixed SPD A (so every s.y > 0), float32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    a = (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)
    s = np.zeros((m, n), np.float32)
    y = np.zeros((m, n), np.float32)
    rho = np.zeros(m, np.float32)
    for j in range(count):
        idx = (head - count + j) % m
        s[idx] = rng.standard_normal(n).astype(np.float32)
        y[idx] = (a @ s[idx]).astype(np.float32)
        rho[idx] = np.float32(1.0) / np.float32(s[idx] @ y[idx])
    return s, y, rho, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("count,head", [(7, 7), (10, 0), (10, 4)],
                         ids=["count_lt_m", "count_eq_m", "wrapped_head"])
def test_two_loop_plain_matches_jax(count, head):
    """(b) the direction kernel's two-loop against JAX's _two_loop_direction
    (m = 10, n = 1,500: two entries a thread in a sum), within 1e-5 of
    max|d|."""
    n, m = 1_500, 10
    s, y, rho, g = _history(n, m, count, head, seed=count + head)
    gamma = np.float32(0.7)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jnp.asarray(s), jnp.asarray(y),
                                   jnp.asarray(rho), count, head, jnp.float32(gamma)))
    got = k_lbfgs.two_loop_reference(torch.from_numpy(g), torch.from_numpy(s),
                                     torch.from_numpy(y), torch.from_numpy(rho), count, head,
                                     gamma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _where_abs(lib):
    return lambda x: lib.sum(lib.where(x >= 0.3, x - 0.3, 0.3 - x))


# 1-D objectives and options, each reaching one branch of the search; |x -
# 0.3| is spelled with where, whose gradient at the kink (the first branch's,
# 1) JAX and torch agree on
BRANCH_CASES = {
    "extend": (lambda lib: (lambda x: lib.sum((x - 50.0) ** 2)), 0.0, {}, 1),
    "bracket_then_zoom": (lambda lib: (lambda x: lib.sum((x - 0.01) ** 2)), 0.0, {}, 1),
    "reversed_zoom": (lambda lib: (lambda x: lib.sum((x - 0.51) ** 2)), 0.0, {}, 3),
    "out_of_budget": (_where_abs, 0.0, {"max_ls": 3}, 3),
    "interval_dead": (_where_abs, 0.0, {}, 3),
    "descent_guard": (lambda lib: (lambda x: lib.sum(1e-25 * x)), 1.0, {"gtol": 0.0}, 3),
}
BRANCH_BITS = {"extend": {"extend"}, "bracket_then_zoom": {"zoom_hi", "zoom_lo"},
               "reversed_zoom": {"zoom_rev"}, "out_of_budget": {"out_of_budget", "fallback"},
               "interval_dead": {"interval_dead", "fallback", "failed"},
               "descent_guard": {"descent_guard"}}


@pytest.mark.parametrize("case", sorted(BRANCH_CASES))
def test_k10_search_branches_match_jax(case):
    """(c) crafted 1-D objectives, each reaching a branch of the search
    (read from the state's branch bits): K10's plain versions take JAX's
    n_iters, n_evals and x (bit for bit in one dimension)."""
    make, x0, opts, iters = BRANCH_CASES[case]
    x = np.full(1, x0, np.float32)
    want = jax_lbfgs(make(jnp), jnp.asarray(x), max_iters=iters, **opts)
    b = k_lbfgs.Buffers.alloc(1, 50, "cpu")
    vg = tl.value_and_grad(make(torch))

    def evaluate():
        if not int(b.si[k_lbfgs.I_DONE]):
            f, g = vg(b.vec[k_lbfgs.XT].clone())
            b.sf[k_lbfgs.F_PHI_T] = f
            b.vec[k_lbfgs.GT].copy_(g)

    k_lbfgs.reset(b, torch.from_numpy(x), max_iters=iters, **opts)
    got = k_lbfgs.run_steps(b, evaluate)
    assert BRANCH_BITS[case] <= set(k_lbfgs.branches_taken(b)), k_lbfgs.branches_taken(b)
    assert (got.n_iters, got.n_evals, got.converged) == (
        int(want.n_iters), int(want.n_evals), bool(want.converged))
    assert float(got.x[0]) == float(want.x[0])


@pytest.mark.parametrize("kind,explicit_inner", [
    ("admm", False), ("admm", True), ("mean_sq", False), ("l2_sq_norm", False),
    ("l1_sq_norm", False)])
def test_k3_value_and_grad_plain_matches_autograd(kind, explicit_inner):
    """(d) K3's value-and-grad mode's plain version, mapped to ravel_tree
    order as K10 runs it (the net from net_offset on, the coefficients'
    entries left at 0), against make_loss_fn's value and its torch.autograd
    gradient over every param, the frozen coefficients' zeros included."""
    upd = dict(_admm_updates(), **{"loss.residual_kind": kind,
                                   "loss.explicit_inner": explicit_inner})
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), upd), "cpu", dataset=GRID)
    inp = _admm_inputs(seed=83)
    params = _params(inp["net"], LAM1, LAM2, lambda v: torch.from_numpy(np.asarray(v, np.float32)))
    colloc = torch.from_numpy(inp["colloc"])
    admm = ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"])) \
        if kind == "admm" else None
    x, unravel = tl.ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    grad, loss = torch.zeros_like(x), torch.zeros(1)
    cfg = k_fused.loss_config(tp.exp)
    k_fused.fused_value_and_grad(tp.spec, x[off:], grad[off:], loss, tp.x_data,
                                 tp.targets["u"].contiguous(), colloc,
                                 None if admm is None else admm.z,
                                 None if admm is None else admm.dual, rho=10.0, **cfg)
    f, g = tl.value_and_grad(lambda v: ttrainer.make_loss_fn(tp)(unravel(v), colloc, admm,
                                                                   10.0)[0])(x.clone())
    np.testing.assert_allclose(float(loss), float(f), rtol=1e-5)
    assert off == 2 and float(grad[:off].abs().max()) == 0.0 and float(g[:off].abs().max()) == 0.0
    pos = off
    for layer in params["net"]:
        for leaf in (layer["W"], layer["b"]):
            want = g[pos:pos + leaf.numel()].numpy()
            np.testing.assert_allclose(grad[pos:pos + leaf.numel()].numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())
            pos += leaf.numel()
    skipped = torch.full_like(grad, 7.0)
    k_fused.fused_value_and_grad(tp.spec, x[off:], skipped[off:], loss, tp.x_data,
                                 tp.targets["u"].contiguous(), colloc,
                                 None if admm is None else admm.z,
                                 None if admm is None else admm.dual, rho=10.0,
                                 skip=torch.ones(1, dtype=torch.int32), **cfg)
    assert float(skipped.min()) == float(skipped.max()) == 7.0


IN_SCOPE = ("abgrall_admm", "burgers_forward", "burgers_admm_batch", "burgers_batch_l1sq",
            "hwan_admm")
OUT_OF_SCOPE = {"hwan_l2": "data_kind", "burgers_inverse": "trainable",
                "abgrall_l1": "width above 32", "abgrall_visc": "width above 32",
                "burgers_scale": "microbatching", "euler_admm": "pde.kind",
                "twosin_weak": "residual_kind", "euler_weak_fast": "pde.kind"}


@pytest.mark.parametrize("name", IN_SCOPE + tuple(sorted(OUT_OF_SCOPE)))
def test_lbfgs_device_supported_reasons(name):
    """(e) K10's scope: the Burgers strong-form presets at 8x20 whose loss
    K3 computes are inside it (whatever their lr schedule or sampling
    strategy); every other preset names why it is not."""
    from pinns_tpu_torch.models.mlp import MLPSpec

    exp = PRESETS[name]
    spec = MLPSpec(layers=exp.model.layers, lb=(-1.0, 0.0), ub=(1.0, 1.0),
                   n_paths=exp.model.n_paths)
    why = k_lbfgs.lbfgs_device_supported(exp, spec)
    if name in IN_SCOPE:
        assert why == []
    else:
        assert why and any(OUT_OF_SCOPE[name] in w for w in why), why


def test_lbfgs_device_supported_refuses_policies():
    """(e) a mixed stream policy, float64 and a net deeper than K3 takes
    stay on the host loop."""
    from pinns_tpu_torch.models.mlp import MLPSpec

    exp = get_preset("abgrall_admm")
    for spec, word in (
            (MLPSpec(layers=exp.model.layers, lb=(-1.0, 0.0), ub=(1.0, 1.0),
                     compute_dtype="bfloat16"), "mixed"),
            (MLPSpec(layers=exp.model.layers, lb=(-1.0, 0.0), ub=(1.0, 1.0),
                     dtype=torch.float64), "float32"),
            (MLPSpec(layers=(2,) + (8,) * 33 + (1,), lb=(-1.0, 0.0), ub=(1.0, 1.0)), "layers")):
        why = k_lbfgs.lbfgs_device_supported(exp, spec)
        assert any(word in w for w in why), why


def test_cpu_trainer_keeps_the_host_loop():
    """On the CPU the trainer's L-BFGS step is the host loop (K10 is the
    card's); a DeviceLBFGS out of scope raises."""
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), _admm_updates()), "cpu",
                                dataset=GRID)
    assert ttrainer.make_lbfgs_step(tp).solver is None
    wide = ttrainer.build_problem(override(get_preset("abgrall_admm"), dict(
        _admm_updates(), **{"model.layers": (2, 40, 40, 1)})), "cpu", dataset=GRID)
    with pytest.raises(NotImplementedError, match="K10"):
        k_lbfgs.DeviceLBFGS(wide)


def test_block_sum_reference_order():
    """The plain versions' sum spells the kernels' order: thread partials
    over entries t, t + THREADS, ..., then the two butterflies (spelled here
    in numpy float32); it agrees with float64 to float32 rounding."""
    threads, warps = k_lbfgs.THREADS, k_lbfgs.WARPS
    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal(3_023) * 10.0 ** rng.uniform(-3, 3, 3_023))
                         .astype(np.float32))
    got = float(k_lbfgs.block_sum_reference(v))
    assert abs(got - math.fsum(v.double().tolist())) <= 1e-5 * float(v.abs().sum())
    lanes = np.zeros(threads, np.float32)
    for t in range(threads):
        for i in range(t, 3_023, threads):
            lanes[t] = np.float32(lanes[t] + v[i].item())
    w = lanes.reshape(warps, 32)
    for off in (16, 8, 4, 2, 1):
        w = (w[:, :off] + w[:, off:2 * off]).astype(np.float32)
    w = w.reshape(warps)
    off = warps // 2
    while off:
        w = (w[:off] + w[off:2 * off]).astype(np.float32)
        off //= 2
    assert got == float(w[0])


def _cluster_sum_model(v: np.ndarray, cluster: int) -> np.ndarray:
    """The cluster kernels' sum of ``v`` (float32), spelled as their
    dataflow (``csrc/lbfgs.cu``'s head): ``cluster`` CTAs of THREADS //
    cluster threads, local thread j of rank c the virtual thread
    c * THREADS // cluster + j, adding its entries t, t + THREADS, ... in
    turn; each warp of each CTA reduces by the butterfly (lane l takes lane
    l ^ off, offsets 16, ..., 1); lane r of every warp stores the warp's sum
    into slot (virtual warp) of CTA r; every CTA runs the 32-way tree on its
    32 slots in warp order. Returns each CTA's total."""
    threads, warps = k_lbfgs.THREADS, k_lbfgs.WARPS
    tpb = threads // cluster
    rows = -(-v.shape[0] // threads)
    padded = np.zeros(rows * threads, np.float32)
    padded[:v.shape[0]] = v
    padded = padded.reshape(rows, threads)
    slots = np.full((cluster, warps), np.nan, np.float32)
    for c in range(cluster):
        part = np.zeros(tpb, np.float32)
        for r in range(rows):  # a thread's entries in turn
            part = (part + padded[r, c * tpb:(c + 1) * tpb]).astype(np.float32)
        for w in range(tpb // 32):
            lanes = part[32 * w:32 * w + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
            assert np.unique(lanes.view(np.uint32)).size == 1  # every lane holds the sum
            for r in range(cluster):  # lane r stores into CTA r
                slots[r, c * (tpb // 32) + w] = lanes[r]
    totals = np.zeros(cluster, np.float32)
    for r in range(cluster):
        w, off = slots[r], warps // 2
        while off:
            w = (w[:off] + w[off:2 * off]).astype(np.float32)
            off //= 2
        totals[r] = w[0]
    return totals


@pytest.mark.parametrize("n", [1, 100, 3_023, 8_193, 33_000])
@pytest.mark.parametrize("cluster", [8, 16])
def test_cluster_dataflow_keeps_block_sum_bits(cluster, n):
    """The cluster layout's sum (per-CTA thread partials, per-warp
    butterflies, the 32 warp sums gathered in warp order into every CTA, the
    final tree) equals block_sum_reference, the plain versions' sum, bit for
    bit in every CTA, on seeded float32 terms spread over six decades: at
    the direction kernel's 8 CTAs, and at 16 (the tree does not depend on
    how the 32 warps are spread over the CTAs)."""
    rng = np.random.default_rng(cluster * 100_003 + n)
    v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    got = _cluster_sum_model(v, cluster)
    want = np.float32(k_lbfgs.block_sum_reference(torch.from_numpy(v)).item())
    assert (got.view(np.uint32) == want.view(np.uint32)).all(), (got, want)


def _largest_scope_net():
    """The deepest width-32 net inside K10's scope and its flat size (the
    net and abgrall_admm's two frozen coefficients)."""
    from pinns_tpu_torch.models.mlp import MLPSpec

    base = get_preset("abgrall_admm")
    best = None
    for depth in range(1, k_fused.MAX_LAYERS + 2):
        layers = (2,) + (k_fused.NARROW_WIDTH,) * depth + (1,)
        spec = MLPSpec(layers=layers, lb=(0.0, 0.0), ub=(1.0, 1.0))
        exp = override(base, {"model.layers": layers})
        if not k_lbfgs.lbfgs_device_supported(exp, spec):
            best = (layers, spec.n_params + 2)
    return best


def test_cluster_plan_fits_shared_memory():
    """cluster_plan keeps a CTA's shared memory within a block's 232,448
    bytes over a grid of n and m, counts it as direction_smem does, holds
    the pairs resident wherever they fit on the 8 CTAs and streams them
    elsewhere: resident at abgrall_admm's n = 3,023, m = 50, streamed at the
    scope's largest net; it refuses a history no design holds."""
    assert k_lbfgs.CLUSTER == 8
    for n in (1, 100, 1_024, 3_023, 7_523, 8_193, 31_811, 33_000):
        for m in (1, 3, 10, 50, 100):
            plan = k_lbfgs.cluster_plan(n, m)
            assert plan.smem <= k_lbfgs.SMEM_LIMIT == 232_448
            assert plan.smem == k_lbfgs.direction_smem(n, m, plan.resident)
            assert plan.per == -(-n // 1024)
            assert plan.resident == (k_lbfgs.direction_smem(n, m, True) <= k_lbfgs.SMEM_LIMIT)
    main = k_lbfgs.cluster_plan(3_023, 50)
    assert (main.resident, main.per) == (True, 3)
    assert not k_lbfgs.cluster_plan(8_193, 50).resident
    layers, n = _largest_scope_net()
    assert len(layers) - 1 == k_fused.MAX_LAYERS and n == 31_811
    assert not k_lbfgs.cluster_plan(n, 50).resident
    with pytest.raises(ValueError, match="shared memory"):
        k_lbfgs.cluster_plan(3_023, 20_000)


def test_seeded_state_descent_guard():
    """The seeded states the card checks start from: with a negative gamma
    the plain direction takes the descent guard (d = -g); with the
    history's own gamma it does not, and it sets the search's state."""
    for count in (0, 3, 50):
        b = k_lbfgs.seeded_state(3_023, 50, count, 9, seed=count, gamma=-1.0)
        k_lbfgs.direction(b)
        assert k_lbfgs.branches_taken(b) == ["descent_guard"]
        assert torch.equal(b.vec[k_lbfgs.D], -b.vec[k_lbfgs.G])
    b = k_lbfgs.seeded_state(3_023, 50, 50, 9, seed=1)
    k_lbfgs.direction(b)
    assert k_lbfgs.branches_taken(b) == [] and float(b.sf[k_lbfgs.F_DPHI0]) < 0
    assert int(b.si[k_lbfgs.I_NEED_DIR]) == 0 and int(b.si[k_lbfgs.I_STAGE]) == k_lbfgs.STAGE_SEARCH
