"""K10's outer epochs as chunks (``ops/kernels/lbfgs.py::LBFGSChunk``) and
K3's post-update mode (``ops/kernels/fused_step.py::fused_post_update``) on
the CPU, where both run their plain versions, against the JAX package.

The tolerances: the post-update's z and dual within rtol 1e-4 and 1e-5 of
max|JAX| (the residual through another float32 Taylor-2 order), its misfit
and data term within rtol 1e-4; the runner against JAX's
``make_chunked(make_lbfgs_step)`` over 3 outer epochs with equal
``lbfgs_iters`` in every row, x within phase 37's bound of chip_smoke.py (1%
of the largest step JAX took plus 1e-6 of max|x|), every metrics row within
rtol 1e-4 (with 1e-6 of the row's loss as the floor of a term that
cancels: the misfit once z has caught up with f) and the dual after it with
the atol of test_torch_chunk.py (1e-5 of the terms its update cancels,
max|dual| + rho max|z|). A chunk of L outer epochs equals L chunks of one
bit for bit, and the reset in place equals the reset from a copy of the
iterate.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.losses.misfit import data_misfit as jdata_misfit
from pinns_tpu.models.mlp import mlp_apply as jmlp_apply
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import PRESETS, get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.opt import lbfgs as tl
from pinns_tpu_torch.train import trainer as ttrainer
from test_torch_lbfgs import GRID, _jax_problem, _params
from torch_port_util import numpy_params, numpy_points

NET = (2, 10, 10, 10, 1)  # 3x10
N_F, N_U, MAX_ITERS = 64, 16, 5
LAM1, LAM2 = 1.0, 0.01 / math.pi
STEP_TOL, ULP_TOL = 1e-2, 1e-6  # chip_smoke.py: ITERATE_STEP_TOL, ITERATE_ULP_TOL
OUTER = 3
KINDS = {"drawn_admm": {}, "fixed_admm": {"sampling.strategy": "fixed_uniform"},
         "fixed_l1sq": {"sampling.strategy": "fixed_uniform", "loss.residual_kind": "l1_sq_norm"},
         "drawn_mean_sq": {"loss.residual_kind": "mean_sq"}}


def _updates(case="drawn_admm"):
    return {"model.layers": NET, "sampling.n_f": N_F, "data.n_u": N_U, "pde.lambda2": LAM2,
            "optimizer.kind": "lbfgs", "optimizer.lbfgs.max_iters": MAX_ITERS, **KINDS[case]}


def _inputs(seed=91):
    rng = np.random.default_rng(seed)
    return {"net": numpy_params(NET, seed), "colloc": numpy_points(N_F, seed + 1),
            "z": (0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
            "dual": (1.0 + 0.1 * rng.standard_normal((N_F, 1))).astype(np.float32)}


def _port(case="drawn_admm", seed=91, key=5):
    """The port's problem and a TrainState at seeded inputs (float32)."""
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), _updates(case)), "cpu",
                                dataset=GRID)
    inp = _inputs(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    admm = ADMMState(z=t(inp["z"]), dual=t(inp["dual"])) \
        if tp.exp.loss.residual_kind == "admm" else None
    state = ttrainer.TrainState(params=_params(inp["net"], LAM1, LAM2, t), opt_state=None,
                                admm=admm, colloc=t(inp["colloc"]), key=key, epoch=0, rho=None)
    return tp, state, inp


def _iterate_bound(want, x0):
    want = np.asarray(want, np.float64)
    return STEP_TOL * float(np.abs(want - np.asarray(x0, np.float64)).max()) \
        + ULP_TOL * float(np.abs(want).max())


def _post_args(tp, length=1):
    """A post-update's own buffers: metrics rows, cursor, schedule, table."""
    return {"metrics": torch.zeros(length, 7), "cursor": torch.zeros(1, dtype=torch.int32),
            "sched": torch.from_numpy(k_fused.chunk_schedule(0, 0, length)),
            "members": k_fused.member_table([5], [tp.exp.loss.rho], N_F, "cpu")}


@pytest.mark.parametrize("case", ["drawn_admm", "fixed_admm", "drawn_mean_sq"])
def test_post_update_plain_matches_jax(case):
    """K3's post-update mode's plain version, fed JAX's next batch (a fixed
    batch keeps its own), against JAX's _post_update and the data term of
    its make_lbfgs_step: the batch equal, z and dual within rtol 1e-4 / 1e-5
    of max|JAX|, the misfit and the data term within rtol 1e-4, then the
    metrics row (loss = the solve's f, res_term = f - data_term, the
    coefficients, the iterations) and the cursor moved on by one."""
    tp, state, inp = _port(case)
    jp = _jax_problem(_updates(case), jnp.float32)
    jparams = _params(inp["net"], LAM1, LAM2, lambda v: jnp.asarray(v, jnp.float32))
    jadmm = None if state.admm is None else JADMM(z=jnp.asarray(inp["z"]),
                                                   dual=jnp.asarray(inp["dual"]))
    admm, colloc, _, mis = jtrainer._post_update(jp, jparams, jadmm, jnp.asarray(inp["colloc"]),
                                                 jax.random.key(5), epoch=0)
    data = jdata_misfit(jmlp_apply(jp.spec, jparams["net"], jp.x_data), jp.targets["u"],
                        "mse_sum", N_U)
    flat, _ = tl.ravel_tree(state.params)
    off = k_lbfgs.net_offset(state.params)
    fixed = tp.exp.sampling.strategy != "resample_uniform"
    args = _post_args(tp)
    feed = None if fixed else torch.from_numpy(np.array(colloc))[None]
    z = None if state.admm is None else state.admm.z.clone()
    dual = None if state.admm is None else state.admm.dual.clone()
    batch = state.colloc.clone()
    f_in, iters = torch.tensor([0.75]), torch.tensor([7], dtype=torch.int32)
    cfg = k_fused.loss_config(tp.exp)
    k_fused.fused_post_update(tp.spec, flat[off:], tp.x_data, tp.targets["u"].contiguous(), batch,
                              z, dual, args["metrics"], args["cursor"], args["sched"],
                              args["members"], f_in, iters, kind=cfg["kind"], lam1=cfg["lam1"],
                              lam2=cfg["lam2"], feed=feed, fixed=fixed)
    np.testing.assert_array_equal(batch.numpy(), np.asarray(colloc))
    if admm is not None:
        for got, want in ((z, admm.z), (dual, admm.dual)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())
    row = dict(zip(ttrainer.METRIC_KEYS, args["metrics"][0].tolist()))
    np.testing.assert_allclose(row["admm_misfit"], float(mis), rtol=1e-4)
    np.testing.assert_allclose(row["data_term"], float(data), rtol=1e-4)
    want_res = float(np.float32(0.75) - np.float32(row["data_term"]))
    assert (row["loss"], row["res_term"], row["lbfgs_iters"]) == (0.75, want_res, 7.0)
    assert (row["lambda1"], row["lambda2"]) == (LAM1, float(np.float32(LAM2)))
    assert int(args["cursor"][0]) == 1


def test_post_update_draws_the_steps_batch():
    """Drawn, the post-update's batch at schedule row i is the per-outer-epoch
    step's Philox draw after epoch ``state.epoch + i`` (trainer._resample),
    bit for bit, from the table's seed; the cursor picks the row."""
    tp, state, _ = _port()
    flat, _ = tl.ravel_tree(state.params)
    off = k_lbfgs.net_offset(state.params)
    args = _post_args(tp, length=3)
    args["sched"] = torch.from_numpy(k_fused.chunk_schedule(0, 40, 3))
    args["members"] = k_fused.member_table([2**33 + 7], [10.0], N_F, "cpu")
    args["cursor"][0] = 2
    batch = state.colloc.clone()
    cfg = k_fused.loss_config(tp.exp)
    k_fused.fused_post_update(tp.spec, flat[off:], tp.x_data, tp.targets["u"].contiguous(), batch,
                              state.admm.z.clone(), state.admm.dual.clone(), args["metrics"],
                              args["cursor"], args["sched"], args["members"], torch.ones(1),
                              torch.zeros(1, dtype=torch.int32), kind=cfg["kind"],
                              lam1=cfg["lam1"], lam2=cfg["lam2"])
    assert torch.equal(batch, ttrainer._resample(tp, 2**33 + 7, 40 + 3))
    assert int(args["cursor"][0]) == 3 and float(args["metrics"][:2].abs().max()) == 0.0


def test_post_update_refuses_bad_buffers():
    """The post-update refuses what its kernel cannot take: fed points with a
    fixed batch, z/dual without the 'admm' kind, a member table of another
    shape, the wide design."""
    tp, state, _ = _port()
    flat, _ = tl.ravel_tree(state.params)
    off = k_lbfgs.net_offset(state.params)
    args = _post_args(tp)
    call = lambda **kw: k_fused.fused_post_update(  # noqa: E731
        kw.pop("spec", tp.spec), kw.pop("params", flat[off:]), tp.x_data,
        tp.targets["u"].contiguous(), state.colloc.clone(), state.admm.z.clone(),
        state.admm.dual.clone(), args["metrics"], args["cursor"], args["sched"],
        kw.pop("members", args["members"]), torch.ones(1), torch.zeros(1, dtype=torch.int32),
        lam1=1.0, lam2=0.0, **{"kind": "admm", **kw})
    with pytest.raises(ValueError, match="fixed batch"):
        call(fixed=True, feed=state.colloc[None].clone())
    with pytest.raises(ValueError, match="z/dual"):
        call(kind="mean_sq")
    with pytest.raises(ValueError, match="members"):
        call(members=torch.zeros(2, 4, dtype=torch.int32))
    from pinns_tpu_torch.models.mlp import MLPSpec

    wide = MLPSpec(layers=(2, 40, 1), lb=tp.spec.lb, ub=tp.spec.ub)
    with pytest.raises(ValueError, match="narrow"):
        call(spec=wide, params=torch.zeros(wide.n_params))


def _jax_batches(jp, key, epoch, n):
    """The batches JAX's L-BFGS outer epochs draw from ``key``: each
    _post_update splits the key and draws from the subkey."""
    out = []
    for i in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jtrainer._resample(jp, sub, epoch + i)))
    return np.stack(out)


def test_cpu_runner_matches_jax_make_chunked():
    """The runner's CPU structure (K10's plain steps, the post-update's plain
    version, the reset in place) over OUTER outer epochs fed JAX's batches,
    against JAX's make_chunked(make_lbfgs_step) from the same float32 state:
    equal lbfgs_iters in every row, x within phase 37's bound, the batch,
    z and dual after the chunk, and every metrics row within rtol 1e-4."""
    tp, state, inp = _port()
    jp = _jax_problem(_updates(), jnp.float32)
    jparams = _params(inp["net"], LAM1, LAM2, lambda v: jnp.asarray(v, jnp.float32))
    jstate = jtrainer.TrainState(
        params=jparams, opt_state=None,
        admm=JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"])),
        colloc=jnp.asarray(inp["colloc"]), key=jax.random.key(5),
        epoch=jnp.zeros((), jnp.int32))
    feed = _jax_batches(jp, jax.random.key(5), 0, OUTER)
    x0 = np.asarray(ravel_pytree(jparams)[0])
    jfinal, jm = jtrainer.make_chunked(jtrainer.make_lbfgs_step(jp), OUTER)(jstate)
    want_x = np.asarray(ravel_pytree(jfinal.params)[0])
    runner = k_lbfgs.LBFGSChunk(tp, max_len=OUTER)
    got, gm = runner.run(state, OUTER, new_colloc=torch.from_numpy(feed))
    assert got.epoch == OUTER and got.opt_state is None and got.key == 5
    assert gm["lbfgs_iters"].tolist() == np.asarray(jm["lbfgs_iters"], np.float32).tolist()
    x = tl.ravel_tree(got.params)[0].numpy()
    err = float(np.abs(x.astype(np.float64) - want_x).max())
    assert err <= _iterate_bound(want_x, x0), (err, _iterate_bound(want_x, x0))
    np.testing.assert_array_equal(got.colloc.numpy(), feed[-1])
    np.testing.assert_array_equal(np.asarray(jfinal.colloc), feed[-1])
    # dual + rho (f - z) cancels terms of size rho max|z|: its atol scales
    # with them, as test_torch_chunk.py and chip_smoke.py's phase 8 hold it
    z_want, dual_want = np.asarray(jfinal.admm.z), np.asarray(jfinal.admm.dual)
    np.testing.assert_allclose(got.admm.z.numpy(), z_want, rtol=1e-4,
                               atol=1e-5 * np.abs(z_want).max())
    np.testing.assert_allclose(got.admm.dual.numpy(), dual_want, rtol=1e-4, atol=1e-5 * (
        np.abs(dual_want).max() + tp.exp.loss.rho * np.abs(z_want).max()))
    for k in ttrainer.METRIC_KEYS:
        want = np.asarray(jm[k], np.float64)
        loss = np.abs(np.asarray(jm["loss"], np.float64))
        assert gm[k].shape == (OUTER,)
        assert np.all(np.abs(gm[k].numpy() - want) <= 1e-4 * np.abs(want) + 1e-6 * loss), \
            (k, gm[k].tolist(), want.tolist())


@pytest.mark.parametrize("case,length,fed", [("drawn_admm", 3, False), ("drawn_admm", 3, True),
                                             ("fixed_l1sq", 2, False)])
def test_chunk_equals_one_epoch_chunks(case, length, fed):
    """A chunk of ``length`` outer epochs equals ``length`` chunks of one
    (the outer epochs driven one host call each, through the same plain
    versions) bit for bit: x, the batch, z, dual and every metrics row;
    drawn, fed and on a fixed batch of another residual kind."""
    tp, state, _ = _port(case)
    runner = k_lbfgs.LBFGSChunk(tp, max_len=4)
    feed = torch.from_numpy(np.stack([numpy_points(N_F, seed=s) for s in range(length)])) \
        if fed else None
    got, gm = runner.run(state, length, new_colloc=feed)
    one, rows = state, []
    for i in range(length):
        one, m = runner.run(one, 1, new_colloc=None if feed is None else feed[i:i + 1])
        rows.append(m)
    assert got.epoch == one.epoch == length
    assert torch.equal(tl.ravel_tree(got.params)[0], tl.ravel_tree(one.params)[0])
    assert torch.equal(got.colloc, one.colloc)
    if fed:
        assert torch.equal(got.colloc, feed[-1])
    if state.admm is not None:
        assert torch.equal(got.admm.z, one.admm.z) and torch.equal(got.admm.dual, one.admm.dual)
    else:
        assert got.admm is None and torch.equal(got.colloc, state.colloc)
    for k in ttrainer.METRIC_KEYS:
        assert torch.equal(gm[k], torch.cat([m[k] for m in rows])), k


def test_runner_tracks_the_per_outer_epoch_step():
    """On the CPU the runner and the trainer's per-outer-epoch step (the host
    loop, K1's plain residual, the plain data term) take the same branches
    over two outer epochs: equal iterations, x within phase 37's bound, the
    batch equal (one Philox draw) and the metrics within rtol 1e-4."""
    tp, state, _ = _port()
    got, gm = k_lbfgs.LBFGSChunk(tp).run(state, 2)
    step = ttrainer.make_lbfgs_step(tp)
    want, wm = ttrainer.run_chunk(step, state, 2)
    x0 = tl.ravel_tree(state.params)[0].numpy()
    wx = tl.ravel_tree(want.params)[0].numpy()
    err = float(np.abs(tl.ravel_tree(got.params)[0].numpy() - wx).max())
    assert err <= _iterate_bound(wx, x0)
    assert torch.equal(got.colloc, want.colloc)
    for k in ttrainer.METRIC_KEYS:
        np.testing.assert_allclose(gm[k].numpy(), wm[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * float(wm["loss"].abs().max()), err_msg=k)


@pytest.mark.parametrize("count", [0, 7])
def test_reset_in_place_equals_reset_reference(count):
    """The reset in place (x0 None: the iterate vec[X] stays, the trial point
    takes it) equals reset_reference from a copy of vec[X], bit for bit, on
    every buffer; the history is left as it was."""
    b = k_lbfgs.seeded_state(300, 10, count, 3, seed=count)
    b.vec[k_lbfgs.GT].fill_(5.0)
    twin = b.clone()
    consts = k_lbfgs.solve_constants(ftol=1e-12, gtol=1e-7)
    k_lbfgs.reset(b, None, max_iters=17, max_ls=9, ftol=1e-12, gtol=1e-7)
    k_lbfgs.reset_reference(twin, twin.vec[k_lbfgs.X].clone(), 17, 9, consts)
    assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))
    assert torch.equal(b.vec[k_lbfgs.XT], b.vec[k_lbfgs.X])
    assert float(b.vec[k_lbfgs.GT].abs().max()) == 0.0
    assert (int(b.si[k_lbfgs.I_MAX_ITERS]), int(b.si[k_lbfgs.I_COUNT])) == (17, 0)


CHUNK_IN_SCOPE = ("abgrall_admm", "burgers_admm_batch", "burgers_batch_l1sq", "burgers_forward",
                  "hwan_admm")
CHUNK_OUT = {"burgers_inverse": "trainable", "abgrall_l1": "width above 32",
             "euler_weak_tail": "pde.kind", "hwan_l2": "data_kind"}
CHUNK_OVERRIDES = {"curriculum": ({"sampling.t_curriculum_epochs": 100}, "time curriculum"),
                   "rad": ({"sampling.strategy": "rad"}, "sampling.strategy")}


@pytest.mark.parametrize("name", CHUNK_IN_SCOPE + tuple(sorted(CHUNK_OUT))
                         + tuple(sorted(CHUNK_OVERRIDES)))
def test_lbfgs_chunk_supported_reasons(name):
    """The runner's scope: K10's (lbfgs_device_supported) with a next batch
    that K3's post-update makes. Inside: the uniform draw (abgrall_admm,
    burgers_admm_batch), the fixed batches (fixed_uniform, fixed_lhs_anchored:
    burgers_batch_l1sq, burgers_forward, hwan_admm) and the kinds that only
    draw or keep their batch (l1_sq_norm, mean_sq); outside, K10's reasons,
    RAD and the time curriculum, each named."""
    from pinns_tpu_torch.models.mlp import MLPSpec

    if name in CHUNK_OVERRIDES:
        upd, word = CHUNK_OVERRIDES[name]
        exp = override(get_preset("abgrall_admm"), upd)
    else:
        exp, word = PRESETS[name], CHUNK_OUT.get(name)
    spec = MLPSpec(layers=exp.model.layers, lb=(-1.0, 0.0), ub=(1.0, 1.0),
                   n_paths=exp.model.n_paths)
    why = k_lbfgs.lbfgs_chunk_supported(exp, spec)
    if word is None:
        assert why == [] and not k_lbfgs.lbfgs_device_supported(exp, spec)
    else:
        assert why and any(word in w for w in why), why


def test_cpu_trainer_takes_no_runner():
    """On the CPU the trainer's L-BFGS step carries no runner (make_chunked
    runs its per-epoch loop, the host loop); the runner refuses a
    configuration outside its scope."""
    tp, _, _ = _port()
    step = ttrainer.make_lbfgs_step(tp)
    assert step.solver is None and getattr(step, "graphed", None) is None
    assert getattr(ttrainer.make_chunked(step, 10), "runner", None) is None
    out = ttrainer.build_problem(override(get_preset("abgrall_admm"), dict(
        _updates(), **{"sampling.t_curriculum_epochs": 50})), "cpu", dataset=GRID)
    with pytest.raises(NotImplementedError, match="chunk scope"):
        k_lbfgs.LBFGSChunk(out)
