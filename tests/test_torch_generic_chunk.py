"""K9 for the generic step on the CPU: the epoch schedule the generic Adam
step reads from the device (``train.schedule``), the schedule-form step
(``train.trainer.make_adam_epoch``), K11's plain draw
(``ops.kernels.sampling``) and the host half of the graphed runner
(``ops.kernels.generic_chunk``), held to the JAX package and to the step as
it took host scalars.

Tolerances: none. Every comparison here is bit for bit:
- the schedule's learning rate equals optax's schedule, the one JAX's
  ``_make_optimizer`` builds, as float32 at the counts below, and its
  curriculum bounds equal JAX's ``_curriculum_bounds``;
- the schedule-form step equals the step that took the learning rate, the
  bias corrections and the draw's epoch as host values, over three epochs
  (on the CPU ATen divides by a 0-d tensor as by a Python scalar: a true
  division either way);
- the runner's eager chunk on the CPU (the graph's plain version) equals the
  per-epoch loop.
The schedule-form step against JAX's steps is held by the existing fixture
tests (``test_torch_train.py``, ``test_torch_euler.py``,
``test_torch_weakform.py``, ``test_torch_paths.py``) at their tolerances.
The graphed chunk itself runs on the card: ``tests/test_torch_cuda.py -k
generic`` and ``chip_smoke.py`` phase 41.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import OptimizerConfig, override
from pinns_tpu_torch.data import datasets as tds
from pinns_tpu_torch.data.sampling import philox_uniform
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import generic_chunk as k_generic
from pinns_tpu_torch.ops.kernels import sampling as k_sampling
from pinns_tpu_torch.opt.adam import (
    adam_update,
    apply_updates,
    bias_corrections,
    learning_rate_schedule,
    tree_leaves,
    tree_map,
)
from pinns_tpu_torch.train import schedule
from pinns_tpu_torch.train import trainer as ttrainer

COUNTS = (0, 1, 9_999, 199_999, 250_000)  # 250,000: past the schedule's end
SCHEDULE_EPOCHS = 200_000
SMALL = {"burgers": (2, 16, 16, 1), "euler": (2, 16, 16, 3)}
_UNIT = lambda e: ((0.0, 0.0), (1.0, 1.0))  # noqa: E731  (the unit square's bounds)
# the presets whose generic step the card replays, at a small size
STEP_PRESETS = ("euler_admm", "euler_admm_tuned", "twosin_weak", "euler_weak_fast",
                "burgers_forward", "hwan_admm", "burgers_inverse")


def _small(preset: str, **extra):
    exp = get_preset(preset)
    upd = {"model.layers": SMALL[exp.pde.kind], "sampling.n_f": 64, "data.n_u": 32, **extra}
    return override(exp, upd)


# -- the schedule's columns ---------------------------------------------------

@pytest.mark.parametrize("kind", ["constant", "cosine", "exponential"])
def test_schedule_lr_column_matches_optax(kind):
    """A row's learning rate, rounded to float32 as the step rounds it,
    equals the optax schedule of JAX's _make_optimizer at its Adam count, bit
    for bit, at the counts COUNTS; and row i of a chunk is the host
    schedule's value at count + i. (Between those counts the host's numpy
    cos and power and XLA's differ in a few ulps at some counts: ROADMAP
    section 3, P5.)"""
    cfg = OptimizerConfig(learning_rate=2e-3, lr_schedule=kind,
                          schedule_epochs=SCHEDULE_EPOCHS, min_lr_fraction=0.05)
    lr = learning_rate_schedule(cfg)
    if kind == "constant":
        want = lambda c: cfg.learning_rate  # noqa: E731  (optax.adam takes the float)
    elif kind == "cosine":
        want = optax.cosine_decay_schedule(cfg.learning_rate, SCHEDULE_EPOCHS,
                                           alpha=cfg.min_lr_fraction)
    else:
        want = optax.exponential_decay(cfg.learning_rate, SCHEDULE_EPOCHS, 0.1)
    for count in COUNTS:
        rows = schedule.row_fields(schedule.schedule_rows(1234, count, 5, 3, lr, _UNIT))
        got = np.float32(rows["lr"][0])
        exp = np.float32(want(jnp.asarray(count, jnp.int32)))
        assert got.view(np.uint32) == exp.view(np.uint32), (kind, count, got, exp)
        for i in range(3):
            assert rows["lr"][i] == (lr(count + i) if callable(lr) else lr)


def test_schedule_curriculum_columns_match_jax():
    """Row i's (lb, ub) are JAX's _curriculum_bounds at the epoch it steps
    (euler_admm_tuned: the t-range grows over 100,000 epochs from a 5%
    floor), as float32 bit for bit; draw 0's row (the initial batch) takes
    epoch 0's."""
    exp = get_preset("euler_admm_tuned")
    ds = tds.GridDataset(x=np.linspace(0, 1, 5), t=np.linspace(0.002032, 0.2008228, 4),
                         fields={"rho": np.zeros((4, 5))})
    tp = ttrainer.Problem(exp=exp, dataset=ds, spec=None, x_data=None, targets={})
    jp = jtrainer.Problem(exp=JPRESETS["euler_admm_tuned"], dataset=ds,
                          spec=JSpec(layers=exp.model.layers, lb=tuple(ds.lb), ub=tuple(ds.ub)),
                          x_data=None, targets={})
    for epoch in (-1, 0, 4_998, 99_997, 249_999):
        rows = schedule.row_fields(ttrainer.adam_schedule(tp, 1e-3, 7, 0, epoch, 3))
        for i in range(3):
            jlb, jub = jtrainer._curriculum_bounds(jp, jnp.asarray(max(epoch + i, 0), jnp.int32))
            np.testing.assert_array_equal(rows["lb"][i].astype(np.float32), np.asarray(jlb))
            np.testing.assert_array_equal(rows["ub"][i].astype(np.float32), np.asarray(jub))


@pytest.mark.parametrize("count,epoch", [(0, 0), (9_999, 12_345), (199_999, 2**32 - 2)])
def test_schedule_words_and_bias_corrections(count, epoch):
    """Row i draws Philox(key, epoch + 1 + i) (low and high words, the high
    word crossed), keyed by the seed's two words, and holds the bias
    corrections at count + i exactly."""
    key = 2**33 + 1234
    rows = schedule.row_fields(schedule.schedule_rows(key, count, epoch, 4, 1e-3, _UNIT))
    for i in range(4):
        e = epoch + 1 + i
        assert (int(rows["epoch"][i][0]), int(rows["epoch"][i][1])) == (e & 0xFFFFFFFF, e >> 32)
        assert (int(rows["seed"][i][0]), int(rows["seed"][i][1])) == (1234, 2)
        assert tuple(rows["bc"][i]) == bias_corrections(count + i)
    assert schedule.ROW_WORDS == 18


# -- K11's plain version ------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1, 2**32 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_plain_draw_is_philox_uniform(epoch, dtype):
    """philox_draw on a CPU schedule reads the row at the cursor and draws
    philox_uniform's points at its seed, epoch and bounds, bit for bit; the
    device cursor picks the row."""
    lb, ub = (-1.0, 0.0), (1.0, np.float32(0.37))
    rows = [schedule.schedule_rows(99, 0, e, 1, 1e-3, lambda e: (lb, ub))
            for e in (100, epoch - 1, 200)]
    sched = torch.from_numpy(np.concatenate(rows))
    got = k_sampling.philox_draw(sched, torch.tensor([1]), 1_000, dtype)
    want = philox_uniform(99, epoch, 1_000, lb, [float(v) for v in ub], dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="int64 cursor"):
        k_sampling.philox_draw(sched, torch.tensor([1], dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="int32 schedule"):
        k_sampling.philox_draw(sched.long(), torch.tensor([1]), 10)


def test_resample_is_the_schedule_draw():
    """The per-epoch step's draw after epoch e (schedule row of e) is the
    host draw of e + 1 (``_resample``), inside the curriculum's bounds."""
    problem = ttrainer.build_problem(_small("euler_admm_tuned"), "cpu")
    for epoch in (0, 3, 70_000):
        sched = torch.from_numpy(ttrainer.adam_schedule(problem, 1e-3, 1234, 0, epoch, 1))
        got = ttrainer._draw_at(problem, sched, torch.zeros(1, dtype=torch.int64), False)
        assert torch.equal(got, ttrainer._resample(problem, 1234, epoch + 1))


# -- the schedule-form step against the host-scalar step ----------------------

def _host_scalar_step(problem, learning_rate, state):
    """The generic epoch as it took host values: the learning rate and the
    bias corrections as Python floats from Adam's count, the draw from the
    state's epoch on the host."""
    loss_fn = ttrainer.make_loss_fn(problem)
    train_coeffs = problem.exp.pde.train_coeffs
    params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    loss, aux = loss_fn(params, state.colloc, state.admm, state.rho)
    wanted = tree_leaves(params["net"]) + (tree_leaves(params["coeffs"]) if train_coeffs else [])
    got = iter(g if g is not None else torch.zeros_like(p) for g, p in
               zip(torch.autograd.grad(loss, wanted, allow_unused=True), wanted))
    grads = {"net": tree_map(lambda p: next(got), params["net"]),
             "coeffs": tree_map(lambda p: next(got) if train_coeffs else torch.zeros_like(p),
                                params["coeffs"])}
    lr = learning_rate(state.opt_state.count) if callable(learning_rate) else learning_rate
    with torch.no_grad():
        updates, opt_state = adam_update(grads, state.opt_state, lr)
        new_params = apply_updates(tree_map(lambda p: p.detach(), params), updates)
    admm, colloc, key, mis = ttrainer._post_update(problem, new_params, state.admm, state.colloc,
                                                   state.key, state.rho, state.epoch)
    new_state = state._replace(params=new_params, opt_state=opt_state, admm=admm, colloc=colloc,
                               epoch=state.epoch + 1)
    return new_state, {**{k: v.detach() for k, v in aux.items()}, "admm_misfit": mis}


def _leaves(state):
    admm = () if state.admm is None else (state.admm.z, state.admm.dual)
    return tree_leaves([state.params, state.opt_state.mu, state.opt_state.nu, list(admm),
                        state.colloc])


def _equal_states(a, b):
    assert a.epoch == b.epoch and a.opt_state.count == b.opt_state.count
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("preset", STEP_PRESETS)
def test_schedule_form_step_equals_the_host_scalar_step(preset):
    """Three epochs of make_adam_step (the schedule row on the device, K11's
    plain draw through the cursor, Adam's rate and bias corrections as 0-d
    tensors) equal the host-scalar step's bit for bit, from an Adam count
    inside the cosine schedule and an epoch inside the curriculum."""
    trainer = ttrainer.Trainer(_small(preset, **{"optimizer.schedule_epochs": 50}), device="cpu")
    state = trainer.init_state()
    state = state._replace(opt_state=state.opt_state._replace(count=17), epoch=23)
    step = ttrainer.make_adam_step(trainer.problem, trainer.learning_rate)
    a, b = state, state
    for _ in range(3):
        a, ma = step(a)
        b, mb = _host_scalar_step(trainer.problem, trainer.learning_rate, b)
        for k in ("loss", "data_term", "res_term", "admm_misfit"):
            assert torch.equal(ma[k], mb[k].to(torch.float32)), k
    _equal_states(a, b)


# -- the scope ------------------------------------------------------------------

def _spec(exp):
    m = exp.model
    return MLPSpec(layers=m.layers, lb=(0.0, 0.0), ub=(1.0, 1.0),
                   dtype=ttrainer._DTYPES[m.dtype], compute_dtype=m.compute_dtype or None,
                   keep_streams=m.keep_streams, mixed_elementwise=m.mixed_elementwise,
                   n_paths=m.n_paths, path_degree=m.path_degree,
                   path_sharpness=m.path_sharpness)


INSIDE = ("euler_admm", "euler_admm_tuned", "euler_inverse", "euler_weak", "euler_weak_fast",
          "euler_weak_tail", "twosin_weak", "burgers_forward", "burgers_inverse",
          "burgers_batch_l1sq", "hwan_l2", "hwan_admm")


@pytest.mark.parametrize("preset", INSIDE)
def test_generic_presets_are_inside_the_scope(preset):
    exp = get_preset(preset)
    from pinns_tpu_torch.ops.kernels.fused_step import fused_step_supported

    assert fused_step_supported(exp, _spec(exp)), "K3 takes it: not a generic preset"
    assert k_generic.generic_chunk_supported(exp, _spec(exp)) == []


@pytest.mark.parametrize("updates,reason", [
    ({}, "sampling.microbatch=128"),
    ({"model.compute_dtype": "bfloat16", "model.keep_streams": ("xx",)}, "mixed stream policy"),
    ({"model.dtype": "float64"}, "model.dtype='float64'"),
])
def test_scope_names_each_left_out_configuration(updates, reason):
    """burgers_scale (128 microbatches), the mixed stream policy and float64
    stay on the per-epoch loop, each with its reason; the runner refuses
    them."""
    exp = override(get_preset("burgers_scale"), updates)
    if "model.dtype" in updates:
        exp = override(get_preset("euler_admm"), updates)
    reasons = k_generic.generic_chunk_supported(exp, _spec(exp))
    assert any(reason in r for r in reasons), reasons
    problem = ttrainer.build_problem(override(exp, {"sampling.n_f": 256, "sampling.microbatch": 2}
                                              if exp.sampling.microbatch > 1 else {}), "cpu")
    with pytest.raises(NotImplementedError, match="per-epoch loop"):
        k_generic.GenericChunk(problem, 1e-3, ttrainer.make_adam_epoch(problem))


def test_cpu_trainer_runs_the_per_epoch_loop():
    """On the CPU the generic step carries no graphed runner: make_chunked
    is the per-epoch loop (the card's scope is the card's)."""
    trainer = ttrainer.Trainer(_small("euler_admm"), device="cpu")
    assert getattr(trainer._adam_step, "graphed", None) is None
    assert callable(trainer._adam_step.epoch)
    assert not hasattr(trainer._get_chunk("adam"), "runner")


# -- the runner's host half, eager on the CPU ---------------------------------

def _runner(trainer, max_len=8):
    problem = trainer.problem
    return k_generic.GenericChunk(problem, trainer.learning_rate, trainer._adam_step.epoch,
                                  max_len=max_len)


@pytest.mark.parametrize("preset", ["euler_admm", "twosin_weak", "burgers_forward",
                                    "burgers_inverse"])
@pytest.mark.parametrize("fed", [False, True])
def test_runner_chunks_equal_the_per_epoch_loop(preset, fed):
    """The runner's chunks (its buffers, the schedule rows at the cursor,
    the metrics rows, the hand-back) run eagerly on the CPU equal the
    per-epoch loop bit for bit: L = 1, 2, 7, two chunks of 5 against one of
    10 (past max_len 8: the rows reallocate), drawn and fed; the state comes
    back with its epoch and Adam's count advanced by L, in tensors of its
    own. (burgers_inverse: a trainable coefficient's metric is a view of
    the params the epoch started from, so the row is written before the
    buffers take the new params.)"""
    trainer = ttrainer.Trainer(_small(preset, **{"optimizer.schedule_epochs": 30}),
                               device="cpu")
    state0 = trainer.init_state()
    n_f = state0.colloc.shape[0]
    runner = _runner(trainer)
    gen = np.random.default_rng(5)
    feed = (torch.from_numpy(gen.uniform(0.0, 0.2, (10, n_f, 2)).astype(np.float32))
            if fed else None)
    for length in (1, 2, 7):
        got, gm = runner.run(state0, length, None if feed is None else feed[:length])
        want, wm = ttrainer.run_chunk(trainer._adam_step, state0, length,
                                      None if feed is None else feed[:length])
        _equal_states(got, want)
        assert got.epoch == state0.epoch + length
        assert got.opt_state.count == state0.opt_state.count + length
        for k in ttrainer.METRIC_KEYS:
            assert gm[k].shape == (length,) and torch.equal(gm[k], wm[k]), k
        assert all(x.data_ptr() != y.data_ptr() for x, y in
                   zip(_leaves(got), tree_leaves([runner.bufs["params"]])))
    mid, _ = runner.run(state0, 5, None if feed is None else feed[:5])
    two, _ = runner.run(mid, 5, None if feed is None else feed[5:])
    one, _ = runner.run(state0, 10, feed)
    assert runner.max_len == 10
    _equal_states(two, one)
    want, _ = ttrainer.run_chunk(trainer._adam_step, state0, 10, feed)
    _equal_states(one, want)


def test_runner_schedule_rows_are_the_steps_rows():
    """The rows a chunk writes are adam_schedule's for the state's key,
    count and epoch, row i the one the per-epoch step writes for its i-th
    epoch."""
    trainer = ttrainer.Trainer(_small("euler_admm_tuned"), device="cpu")
    state = trainer.init_state()._replace(epoch=41)
    state = state._replace(opt_state=state.opt_state._replace(count=40))
    runner = _runner(trainer)
    runner.run(state, 3)
    for i in range(3):
        one = ttrainer.adam_schedule(trainer.problem, trainer.learning_rate, state.key,
                                     40 + i, 41 + i, 1)
        assert np.array_equal(runner.sched[i].numpy(), one[0])


def test_hand_back_advances_epoch_and_count():
    trainer = ttrainer.Trainer(_small("twosin_weak"), device="cpu")
    state = trainer.init_state()
    runner = _runner(trainer)
    runner.run(state, 2)
    new, metrics = k_generic.hand_back(state, runner.bufs, runner.metrics, 2)
    assert (new.epoch, new.opt_state.count) == (state.epoch + 2, state.opt_state.count + 2)
    assert new.key == state.key and new.rho == state.rho and new.admm is None
    assert set(metrics) == set(ttrainer.METRIC_KEYS)
    assert all(v.shape == (2,) for v in metrics.values())


def test_member_loop_runs_members_through_the_solo_runner():
    """An ensemble outside K8 runs each member's Adam chunk through the solo
    runner (``step.graphed``, here the runner's eager form on the CPU):
    every member equals its solo chunk and the per-epoch loop bit for bit."""
    import functools

    from pinns_tpu_torch.parallel import ensemble as ens

    trainer = ttrainer.Trainer(_small("twosin_weak"), device="cpu")
    step = trainer._adam_step
    step.graphed = functools.partial(k_generic.GenericChunk, trainer.problem,
                                     trainer.learning_rate, step.epoch)
    seeds = [1234, 1235, 1236]
    got, metrics = ens.make_ensemble_chunk(trainer, 4)(ens.init_ensemble_states(trainer, seeds))
    assert isinstance(trainer._get_chunk("adam").runner, k_generic.GenericChunk)
    for i, member in enumerate(ens.unstack_states(got, len(seeds))):
        solo = trainer.init_state(seed=seeds[i])
        want, wm = ttrainer.run_chunk(step, solo, 4)
        _equal_states(member, want)
        for k in ttrainer.METRIC_KEYS:
            assert torch.equal(metrics[k][:, i], wm[k]), k
