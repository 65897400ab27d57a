"""Port parity for the training slice: the loss and its gradient, the plain
Adam step and the trainer, held against the JAX package at a small size
(net 2 -> 16x3 -> 1, N_f = 64, N_u = 16; inputs from numpy with a seed), and
the fused CUDA step's hand-written reverse mode held against torch.autograd.

Tolerances: loss, terms and gradients rtol 1e-4 with atol 1e-5 * max|g| per
leaf (float32 sums in other orders). Params after a step: Adam's first update
is lr * g / (|g| + eps), so an entry whose gradient is within rounding of
zero may take the other sign; each step may move such an entry by up to
2 lr, hence atol 2 lr * steps on params, with all but a few entries within
1e-6. z and dual follow the params through the residual at the new points.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import train_state_from_jax, train_state_to_numpy
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import SMALL, numpy_params, numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
N_F, N_U, LR = 64, 16, 1e-3
KINDS = [("admm", False), ("admm", True), ("mean_sq", False), ("l2_sq_norm", False),
         ("l1_sq_norm", False)]
KIND_IDS = ["admm", "admm-explicit", "mean_sq", "l2_sq_norm", "l1_sq_norm"]


def _updates(kind="admm", explicit_inner=False, **extra):
    return {"model.layers": SMALL, "sampling.n_f": N_F, "data.n_u": N_U,
            "pde.lambda2": 0.01 / math.pi, "optimizer.kind": "adam",
            "loss.residual_kind": kind, "loss.explicit_inner": explicit_inner, **extra}


def _jax_problem(updates):
    exp = joverride(JPRESETS["abgrall_admm"], updates)
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    return jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                            targets={k: jnp.asarray(v) for k, v in targets.items()})


def _port_problem(updates, dtype="float32"):
    exp = override(get_preset("abgrall_admm"), dict(updates, **{"model.dtype": dtype}))
    return ttrainer.build_problem(exp, "cpu", dataset=GRID)


def _inputs(seed=41):
    """numpy params (JAX layout), collocation batch, z and dual."""
    rng = np.random.default_rng(seed)
    return {
        "net": numpy_params(SMALL, seed),
        "colloc": numpy_points(N_F, seed + 1),
        "z": (0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
        "dual": (1.0 + 0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
    }


def _jax_params(net, lam1, lam2):
    return {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net],
            "coeffs": {"lambda1": jnp.full((1,), lam1, jnp.float32),
                       "lambda2": jnp.full((1,), lam2, jnp.float32)}}


def _port_params(net, lam1, lam2, dtype=torch.float32):
    return {"net": [{k: torch.tensor(v, dtype=dtype) for k, v in layer.items()} for layer in net],
            "coeffs": {"lambda1": torch.full((1,), lam1, dtype=dtype),
                       "lambda2": torch.full((1,), lam2, dtype=dtype)}}


def _close_grad(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("kind,explicit_inner", KINDS, ids=KIND_IDS)
def test_loss_and_grad_match_jax(kind, explicit_inner):
    upd = _updates(kind, explicit_inner)
    jp, tp = _jax_problem(upd), _port_problem(upd)
    inp = _inputs()
    lam1, lam2 = 1.0, 0.01 / math.pi
    jadmm = JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"])) if kind == "admm" else None
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        _jax_params(inp["net"], lam1, lam2), jnp.asarray(inp["colloc"]), jadmm, None)

    params = _port_params(inp["net"], lam1, lam2)
    leaves = [t.requires_grad_(True) for layer in params["net"] for t in (layer["W"], layer["b"])]
    tadmm = ADMMState(z=torch.from_numpy(inp["z"]), dual=torch.from_numpy(inp["dual"])) \
        if kind == "admm" else None
    tloss, taux = ttrainer.make_loss_fn(tp)(params, torch.from_numpy(inp["colloc"]), tadmm)
    tgrad = torch.autograd.grad(tloss, leaves)

    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4)
    jflat = [jgrad["net"][i][k] for i in range(len(SMALL) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(tgrad, jflat)):
        _close_grad(g.numpy(), w, f"leaf {i}")
    np.testing.assert_array_equal(np.asarray(jgrad["coeffs"]["lambda1"]), 0.0)  # frozen


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,explicit_inner", KINDS, ids=KIND_IDS)
def test_kernel_reverse_mode_matches_autograd(kind, explicit_inner, dtype):
    """The fused step's hand-written reverse mode (loss_and_grad_reference)
    equals torch.autograd of the plain loss: to 1e-10 relative in float64,
    and at the float32 gradient tolerance in float32."""
    upd = _updates(kind, explicit_inner)
    tp = _port_problem(upd, dtype)
    dt = tp.spec.dtype
    inp = _inputs(seed=43)
    lam1, lam2 = 1.0, 0.01 / math.pi
    params = _port_params(inp["net"], lam1, lam2, dt)
    leaves = [t.requires_grad_(True) for layer in params["net"] for t in (layer["W"], layer["b"])]
    colloc = torch.tensor(inp["colloc"], dtype=dt)
    z, dual = torch.tensor(inp["z"], dtype=dt), torch.tensor(inp["dual"], dtype=dt)
    admm = ADMMState(z=z, dual=dual) if kind == "admm" else None
    loss, aux = ttrainer.make_loss_fn(tp)(params, colloc, admm)
    want = torch.autograd.grad(loss, leaves)
    net = [{k: v.detach() for k, v in layer.items()} for layer in params["net"]]
    got_loss, data_term, res_term, got = k_fused.loss_and_grad_reference(
        tp.spec, net, tp.x_data, tp.targets["u"], colloc, z, dual, kind=kind, lam1=lam1,
        lam2=lam2, rho=tp.exp.loss.rho, explicit_inner=explicit_inner)
    rtol = 1e-10 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(float(got_loss), float(loss.detach()), rtol=rtol)
    np.testing.assert_allclose(float(data_term), float(aux["data_term"]), rtol=rtol)
    np.testing.assert_allclose(float(res_term), float(aux["res_term"]), rtol=rtol)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        atol = 1e-10 * scale if dtype == "float64" else 1e-5 * scale
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=f"leaf {i}")


def _jax_state(jp, inp, lam1, lam2, optimizer):
    params = _jax_params(inp["net"], lam1, lam2)
    admm = JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"])) \
        if jp.exp.loss.residual_kind == "admm" else None
    return jtrainer.TrainState(params=params, opt_state=optimizer.init(params), admm=admm,
                               colloc=jnp.asarray(inp["colloc"]), key=jax.random.key(5),
                               epoch=jnp.zeros((), jnp.int32))


def _jax_tree(state):
    adam = state.opt_state[0]
    out = {"params": jax.device_get(state.params), "count": np.asarray(adam.count),
           "mu": jax.device_get(adam.mu), "nu": jax.device_get(adam.nu),
           "colloc": np.asarray(state.colloc), "epoch": np.asarray(state.epoch), "key": 5}
    if state.admm is not None:
        out["z"], out["dual"] = np.asarray(state.admm.z), np.asarray(state.admm.dual)
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("kind", ["admm", "l1_sq_norm"])
def test_plain_steps_track_jax(kind, n_steps):
    """JAX's make_adam_step vs the port's plain step, each step fed JAX's
    resampled points (from JAX's returned colloc)."""
    upd = _updates(kind)
    jp, tp = _jax_problem(upd), _port_problem(upd)
    optimizer = optax.adam(LR)
    jstep = jax.jit(jtrainer.make_adam_step(jp, optimizer))
    tstep = ttrainer.make_adam_step(tp, LR)
    inp = _inputs(seed=45)
    jstate = _jax_state(jp, inp, 1.0, 0.01 / math.pi, optimizer)
    tstate = train_state_from_jax(_jax_tree(jstate), torch.device("cpu"))
    for k in range(n_steps):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate, new_colloc=torch.from_numpy(np.array(jstate.colloc)))
        assert sorted(tm) == sorted(jm)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {k} {name}")
    want = _jax_tree(jstate)
    got = train_state_to_numpy(tstate)
    assert got["count"] == int(want["count"]) == n_steps and got["epoch"] == n_steps
    np.testing.assert_array_equal(got["colloc"], want["colloc"])
    gp = np.concatenate([a.ravel() for layer in got["params"]["net"] for a in layer.values()])
    wp = np.concatenate([np.asarray(a).ravel() for layer in want["params"]["net"]
                         for a in layer.values()])
    diff = np.abs(gp - wp)
    assert diff.max() <= 2 * LR * n_steps * (1 + 1e-3)
    assert np.mean(diff > 1e-6) <= 0.01, np.sort(diff)[-10:]
    for key in ("mu", "nu"):
        g = np.concatenate([a.ravel() for layer in got[key]["net"] for a in layer.values()])
        w = np.concatenate([np.asarray(a).ravel() for layer in want[key]["net"]
                            for a in layer.values()])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=key)
    if kind == "admm":
        for key in ("z", "dual"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-5 * np.abs(want[key]).max(), err_msg=key)


def _tiny(tmp_path, **extra):
    return override(get_preset("abgrall_admm"), dict(_updates(), **{
        "train.epochs": 6, "train.chunk": 2, "train.log_every": 2,
        "train.out_dir": str(tmp_path), **extra}))


def test_trainer_cpu_logs_checkpoints_and_never_launches(tmp_path, monkeypatch):
    monkeypatch.setattr(jtrainer, "enable_compilation_cache", lambda *a, **k: None)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jexp = joverride(JPRESETS["abgrall_admm"], dict(_updates(), **{
        "train.epochs": 4, "train.chunk": 2, "train.log_every": 2, "train.out_dir": str(jdir)}))
    jp = _jax_problem(_updates())
    jp = dataclasses.replace(jp, exp=jexp)
    jtrainer.Trainer(jexp, problem=jp).train()
    exp = _tiny(tdir)
    trainer = ttrainer.Trainer(exp, device="cpu", dataset=GRID)
    before = k_fused.LAUNCHES
    state, summary = trainer.train()
    assert k_fused.LAUNCHES == before  # CPU tensors take the plain step

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    jrec = records(jdir / "abgrall_admm_metrics.jsonl")
    trec = records(tdir / "abgrall_admm_metrics.jsonl")
    assert [sorted(r) for r in trec[:-1]] == [sorted(jrec[0])] * 3
    assert [r["epoch"] for r in trec[:-1]] == [2, 4, 6]
    assert sorted(trec[-1]["summary"]) == sorted(jrec[-1]["summary"])
    assert summary["epochs"] == 6 and summary["truth"] == "native"
    assert all(math.isfinite(v) for r in trec[:-1] for k, v in r.items()
               if isinstance(v, float))

    path = trainer.save_checkpoint(state, tag="test")
    assert ckpt_io.load_meta(path) == {"experiment": "abgrall_admm", "epoch": 6, "rho": None}
    back = trainer.load_checkpoint(path)
    a, b = train_state_to_numpy(state), train_state_to_numpy(back)
    assert a.keys() == b.keys()
    for key in a:
        torch.utils._pytree.tree_map(np.testing.assert_array_equal, a[key], b[key])
    # a resumed run continues exactly where the first one would have gone
    s1, _ = ttrainer.run_chunk(trainer._adam_step, state, 2)
    s2, _ = ttrainer.run_chunk(trainer._adam_step, back, 2)
    torch.utils._pytree.tree_map(np.testing.assert_array_equal,
                                 train_state_to_numpy(s1)["params"],
                                 train_state_to_numpy(s2)["params"])


def test_profile_dir_traces_the_second_chunk(tmp_path):
    """train.profile_dir set: Trainer.train traces its second chunk with
    torch.profiler and writes the trace there, as the JAX trainer does with
    jax.profiler; the run itself is the one without the profiler."""
    trace_dir = tmp_path / "trace"
    exp = _tiny(tmp_path / "out", **{"train.profile_dir": str(trace_dir)})
    state, summary = ttrainer.Trainer(exp, device="cpu", dataset=GRID).train()
    plain, _ = ttrainer.Trainer(_tiny(tmp_path / "plain"), device="cpu", dataset=GRID).train()
    assert sorted(os.listdir(trace_dir)) == ["abgrall_admm_e2.json"]
    with open(trace_dir / "abgrall_admm_e2.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    torch.utils._pytree.tree_map(np.testing.assert_array_equal,
                                 train_state_to_numpy(state)["params"],
                                 train_state_to_numpy(plain)["params"])
    assert summary["epochs"] == 6


def test_hybrid_raises_at_the_lbfgs_switch(tmp_path, monkeypatch):
    """The L-BFGS phase no longer raises at the switch: a hybrid run trains
    through it with the JAX Trainer's phases and chunk lengths (Adam chunks
    clipped at switch_epoch, L-BFGS chunks of max(1, min(chunk // 100 or 1,
    10)) outer epochs), and logs lbfgs_iters."""
    monkeypatch.setattr(jtrainer, "enable_compilation_cache", lambda *a, **k: None)
    hybrid = {"optimizer.kind": "hybrid", "optimizer.switch_epoch": 3,
              "optimizer.lbfgs.max_iters": 4, "train.epochs": 5, "train.log_every": 1}
    jexp = joverride(JPRESETS["abgrall_admm"], dict(_updates(), **{
        "train.chunk": 2, "train.out_dir": str(tmp_path / "jax"), **hybrid}))
    jp = dataclasses.replace(_jax_problem(_updates()), exp=jexp)
    jtrainer.Trainer(jexp, problem=jp).train()
    trainer = ttrainer.Trainer(_tiny(tmp_path / "torch", **hybrid), device="cpu", dataset=GRID)
    state, summary = trainer.train()

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f][:-1]

    jrec = records(tmp_path / "jax" / "abgrall_admm_metrics.jsonl")
    trec = records(tmp_path / "torch" / "abgrall_admm_metrics.jsonl")
    phases = [(r["epoch"], r["phase"]) for r in trec]
    assert phases == [(r["epoch"], r["phase"]) for r in jrec]
    assert phases == [(2, "adam"), (3, "adam"), (4, "lbfgs"), (5, "lbfgs")]
    assert [r["lbfgs_iters"] for r in trec] == [0.0, 0.0, 4.0, 4.0]
    assert state.epoch == summary["epochs"] == 5 and state.opt_state.count == 3
    assert all(math.isfinite(v) for r in trec for v in r.values() if isinstance(v, float))


def test_lr_schedules_match_optax():
    """The port's learning rate at Adam counts {0, 1, mid, end, past end}
    equals optax's schedule (both in float32) for cosine and exponential."""
    from pinns_tpu_torch.config import OptimizerConfig
    from pinns_tpu_torch.opt.adam import learning_rate_schedule

    for kind, want in (
            ("cosine", optax.cosine_decay_schedule(2e-3, 400, alpha=0.05)),
            ("exponential", optax.exponential_decay(2e-3, 400, 0.1))):
        lr = learning_rate_schedule(OptimizerConfig(
            learning_rate=2e-3, lr_schedule=kind, schedule_epochs=400, min_lr_fraction=0.05))
        for count in (0, 1, 200, 400, 1000):
            assert lr(count) == float(want(jnp.asarray(count, jnp.int32))), (kind, count)
    assert learning_rate_schedule(OptimizerConfig()) == 1e-3
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        learning_rate_schedule(OptimizerConfig(lr_schedule="linear"))


def _shipped_schedules():
    """(name, OptimizerConfig) of every preset with a learning-rate schedule,
    and an exponential one (no preset ships it) at the shipped length."""
    from pinns_tpu_torch.config import OptimizerConfig
    from pinns_tpu_torch.experiments.presets import PRESETS

    out = {}
    for name, exp in sorted(PRESETS.items()):
        o = exp.optimizer
        if o.lr_schedule != "constant":
            out.setdefault((o.lr_schedule, o.learning_rate, o.schedule_epochs,
                            o.min_lr_fraction), (name, o))
    out[("exponential", 1e-3, 200_000, 0.0)] = ("exponential", OptimizerConfig(
        learning_rate=1e-3, lr_schedule="exponential", schedule_epochs=200_000))
    return sorted(out.values(), key=lambda v: v[0])


@pytest.mark.parametrize("name,cfg", _shipped_schedules(), ids=lambda v: v if
                         isinstance(v, str) else "")
def test_lr_schedule_equals_optax_at_every_count(name, cfg):
    """P5: the port's schedule table equals optax's under XLA on the CPU bit
    for bit at EVERY count from 0 to 60 past the schedule's end (burgers_forward's
    cosine over 180,000 counts; euler_inverse, euler_weak_fast,
    euler_weak_tail and twosin_weak's over 200,000; an exponential decay over
    200,000), optax's side one vectorised call."""
    from pinns_tpu_torch.opt.adam import learning_rate_schedule
    from pinns_tpu_torch.train.schedule import schedule_rows

    if cfg.lr_schedule == "cosine":
        sched = optax.cosine_decay_schedule(cfg.learning_rate, cfg.schedule_epochs,
                                            alpha=cfg.min_lr_fraction)
    else:
        sched = optax.exponential_decay(cfg.learning_rate, cfg.schedule_epochs, 0.1)
    counts = np.arange(cfg.schedule_epochs + 61)
    want = np.asarray(jax.jit(jax.vmap(sched))(jnp.asarray(counts, jnp.int32)))
    lr = learning_rate_schedule(cfg)
    got = lr(counts)
    assert got.dtype == np.float64 and np.all(got == got.astype(np.float32))
    bad = np.flatnonzero(got.astype(np.float32) != want)
    assert bad.size == 0, (name, bad[:10], got[bad[:10]], want[bad[:10]])
    assert lr(int(counts[-1])) == float(want[-1])
    rows = schedule_rows(1234, 1_000, 999, 7, lr, lambda e: ((0.0, 0.0), (1.0, 1.0)))
    np.testing.assert_array_equal(rows.view(np.float64)[:, 6], want[1_000:1_007])


BF_GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "burgers_shock.npz")


@pytest.mark.parametrize("n_steps", [1, 4])
def test_generic_step_tracks_jax_burgers_forward(n_steps):
    """burgers_forward at a tiny size (the fixed anchored batch, cosine decay
    over 3 epochs, mean_sq): JAX's make_adam_step vs the port's generic step,
    which the card runs outside K3's scope, from the same state."""
    upd = {"model.layers": SMALL, "sampling.n_f": N_F, "data.n_u": N_U,
           "optimizer.schedule_epochs": 3}
    jexp = joverride(JPRESETS["burgers_forward"], upd)
    with np.load(BF_GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, N_U, seed=jexp.data.seed)
    jp = jtrainer.Problem(
        exp=jexp, dataset=ds, spec=JSpec(layers=SMALL, lb=tuple(float(v) for v in ds.lb),
                                         ub=tuple(float(v) for v in ds.ub)),
        x_data=jnp.asarray(x_data), targets={k: jnp.asarray(v) for k, v in targets.items()})
    trainer = ttrainer.Trainer(override(get_preset("burgers_forward"), upd), device="cpu")
    tp = trainer.problem
    assert tp.dataset.provenance == "native" and tp.exp.sampling.strategy == "fixed_lhs_anchored"
    np.testing.assert_array_equal(tp.x_data.numpy(), x_data)
    optimizer = jtrainer._make_optimizer(jexp.optimizer)
    jstep = jax.jit(jtrainer.make_adam_step(jp, optimizer))
    tstep = ttrainer.make_step(tp, trainer.learning_rate)
    inp = _inputs(seed=47)
    inp["colloc"] = np.concatenate([inp["colloc"], jds.ic_bc_candidates(ds)])  # anchored
    jstate = _jax_state(jp, inp, 1.0, 0.01 / math.pi, optimizer)
    tstate = train_state_from_jax(_jax_tree(jstate), torch.device("cpu"))
    for k in range(n_steps):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {k} {name}")
    want, got = _jax_tree(jstate), train_state_to_numpy(tstate)
    np.testing.assert_array_equal(got["colloc"], want["colloc"])  # the fixed batch stays
    gp = np.concatenate([a.ravel() for layer in got["params"]["net"] for a in layer.values()])
    wp = np.concatenate([np.asarray(a).ravel() for layer in want["params"]["net"]
                         for a in layer.values()])
    diff = np.abs(gp - wp)
    assert diff.max() <= 2 * LR * n_steps * (1 + 1e-3)
    assert np.mean(diff > 1e-6) <= 0.01, np.sort(diff)[-10:]


def test_burgers_shock_grid_is_the_native_one(monkeypatch):
    """The committed burgers_shock grid equals the JAX package's Cole-Hopf
    regeneration (the grid burgers_forward trains and is scored on)."""
    from pinns_tpu.data import generators
    from pinns_tpu_torch.data.datasets import load_burgers_mat

    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    port = load_burgers_mat("burgers_shock")
    native = generators.make_burgers_shock_grid(nx=256, nt=100)
    jax_ds = jds.GridDataset(x=native["x"], t=native["t"], fields={"u": native["usol"].T})
    assert port.provenance == "native" and port.fields["u"].shape == (100, 256)
    np.testing.assert_array_equal(port.X_star, jax_ds.X_star)
    np.testing.assert_array_equal(port.star["u"], jax_ds.star["u"])


def test_abgrall_grid_is_the_native_one(monkeypatch):
    """The committed abgrall_burgers_shock grid equals the JAX package's
    regeneration (generators.make_abgrall_burgers_grid, 257 x 257)."""
    from pinns_tpu.data import generators
    from pinns_tpu_torch.data.datasets import load_burgers_mat

    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    port = load_burgers_mat("abgrall_burgers_shock")
    native = generators.make_abgrall_burgers_grid()
    jax_ds = jds.GridDataset(x=native["x"].astype(np.float32), t=native["t"].astype(np.float32),
                             fields={"u": native["usol"].astype(np.float32).T})
    assert port.provenance == "native" and port.fields["u"].shape == (257, 257)
    np.testing.assert_array_equal(port.X_star, jax_ds.X_star)
    np.testing.assert_array_equal(port.star["u"], jax_ds.star["u"])


@pytest.mark.parametrize("preset", ["hwan_l2", "abgrall_l1", "abgrall_l2", "abgrall_visc"])
def test_abgrall_presets_build_on_their_grid(monkeypatch, preset):
    """The four presets that train on abgrall_burgers_shock build their
    problem from the committed grid, with JAX's training set on it."""
    from pinns_tpu_torch.data.datasets import load_burgers_mat

    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    problem = ttrainer.build_problem(get_preset(preset), "cpu")
    ds = load_burgers_mat("abgrall_burgers_shock")
    exp = JPRESETS[preset]
    build = (jds.interior_training_set if exp.data.selection == "interior"
             else jds.build_ic_bc_training_set)
    jds_grid = jds.GridDataset(x=ds.x, t=ds.t, fields={"u": ds.fields["u"]})
    x_data, targets = build(jds_grid, exp.data.n_u, seed=exp.data.seed, noise=exp.data.noise)
    assert problem.dataset.name == "abgrall_burgers_shock"
    assert problem.spec.lb == tuple(float(v) for v in ds.lb)
    np.testing.assert_array_equal(problem.x_data.numpy(), np.asarray(x_data, np.float32))
    np.testing.assert_array_equal(problem.targets["u"].numpy(),
                                  np.asarray(targets["u"], np.float32))
    colloc = ttrainer.init_collocation(problem, 1234)
    assert colloc.shape[0] >= problem.exp.sampling.n_f and torch.isfinite(colloc).all()


@pytest.mark.parametrize("preset,match", [
    ("euler_admm", "slice 2"), ("twosin_weak", "slice 2"), ("euler_weak", "slice 2"),
])
def test_out_of_slice_presets_raise(preset, match):
    # euler_admm is inside the port since slice 2a, twosin_weak since slice
    # 2b-i and euler_weak since slice 2b-ii; with Fourier features (the rest
    # of slice 2b-iii) each still is: the only refusal left is multi-GPU's,
    # and no slice-2 feature is named in it any more
    exp = override(get_preset(preset), {"model.n_fourier": 4})
    ttrainer.check_slice(exp)
    with pytest.raises(NotImplementedError, match="slice 6") as err:
        ttrainer.check_slice(override(exp, {"mesh.data_parallel": 2}))
    assert match not in str(err.value)


def test_fused_step_scope():
    spec_of = lambda exp: ttrainer.MLPSpec(layers=exp.model.layers, lb=(-1.0, 0.0),  # noqa: E731
                                           ub=(1.0, 1.0))
    for name in ("abgrall_admm", "abgrall_l1", "abgrall_l2", "abgrall_visc",
                 "burgers_admm_batch"):
        assert k_fused.fused_step_supported(get_preset(name), spec_of(get_preset(name))) == []
    for name in ("burgers_forward", "hwan_admm", "burgers_batch_l1sq", "burgers_inverse"):
        assert k_fused.fused_step_supported(get_preset(name), spec_of(get_preset(name)))
    # on the card a configuration outside the scope raises instead of falling back
    problem = _port_problem(_updates(**{"sampling.strategy": "fixed_uniform"}))
    with pytest.raises(NotImplementedError, match="outside the fused CUDA step"):
        k_fused.make_fused_adam_step(problem, LR)


def test_fused_wrapper_raises_on_cpu_tensors():
    tp = _port_problem(_updates())
    flat = torch.zeros(tp.spec.n_params)
    colloc = torch.zeros(N_F, 2)
    before = k_fused.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_fused.fused_adam_step(tp.spec, flat, flat, flat, 0, tp.x_data, tp.targets["u"],
                                colloc, torch.zeros(N_F, 1), torch.ones(N_F, 1), kind="admm",
                                lam1=1.0, lam2=0.0, rho=10.0, lr=LR, explicit_inner=False,
                                seed=1, epoch=1)
    assert k_fused.LAUNCHES == before


def test_cli_train_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "pinns_tpu_torch", "train", "--preset", "abgrall_admm",
         "--epochs", "3", "--chunk", "2", "--device", "cpu", "--seed", "5",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(summary) == ["epochs", "lambda1", "lambda2", "rel_l2_u", "truth"]
    assert summary["epochs"] == 3 and 0.0 < summary["rel_l2_u"] < 10.0
    assert (tmp_path / "abgrall_admm_metrics.jsonl").exists()
    assert (tmp_path / "abgrall_admm_final.ckpt").exists()
