"""Port parity for ensembles (``pinns_tpu_torch.parallel.ensemble``): the
member-batched step against JAX's vmapped one, each member against its solo
run, ground-truth-free selection against JAX's, the per-member artifacts and
resume of ``train --ensemble``, and the refusals of K8's wrapper and of the
features later slices bring.

Small sizes: net 2 -> 8x2 -> 1, N_f 64, N_u 16, three members with rhos
(1, 10, 40), on the committed TwoSin grid; inputs from the JAX package's own
initialization, handed over as numpy.

Tolerances: the step as the training row (``test_torch_train.py``): loss and
terms rtol 1e-4 / atol 1e-6, the Adam moments (the gradient after one step)
rtol 1e-4 / atol 1e-5 max|.| per leaf, params within 2 lr; z and dual rtol
1e-4 / atol 1e-5 max|.|. Selection scores rtol 1e-5 (float32 means in
another order). A member against its solo run of the port: bit for bit.
"""

import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.data.sampling import uniform_box as juniform_box
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.parallel import ensemble as jens
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch import cli
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import ensemble_state_from_jax
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
CPU = torch.device("cpu")
LAYERS = (2, 8, 8, 1)
N_F, N_U, LR = 64, 16, 1e-3
SEEDS = (1234, 1235, 1236)
RHOS = (1.0, 10.0, 40.0)


def _updates(**extra):
    return {"model.layers": LAYERS, "sampling.n_f": N_F, "data.n_u": N_U,
            "optimizer.kind": "adam", "train.log_every": 0, **extra}


def _jax_trainer(preset="abgrall_admm", **extra):
    exp = joverride(JPRESETS[preset], _updates(**extra))
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    problem = jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                               targets={k: jnp.asarray(v) for k, v in targets.items()})
    return jtrainer.Trainer(exp, problem=problem)


def _exp(preset="abgrall_admm", **extra):
    return override(get_preset(preset), _updates(**extra))


def _trainer(preset="abgrall_admm", **extra):
    return ttrainer.Trainer(_exp(preset, **extra), device="cpu", dataset=GRID)


def _jax_tree(stacked):
    """JAX's stacked state as the numpy tree of ensemble_state_from_jax (a
    copy: JAX's chunk donates its input buffers)."""
    adam = stacked.opt_state[0]
    cp = lambda t: jax.tree_util.tree_map(lambda a: np.array(a), t)  # noqa: E731
    out = {"params": cp(stacked.params), "count": np.array(adam.count), "mu": cp(adam.mu),
           "nu": cp(adam.nu), "colloc": np.array(stacked.colloc), "epoch": np.array(stacked.epoch)}
    if stacked.admm is not None:
        out["z"], out["dual"] = np.array(stacked.admm.z), np.array(stacked.admm.dual)
    if stacked.rho is not None:
        out["rho"] = np.array(stacked.rho)
    return out


def _leaves(tree) -> list:
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree) -> list:
    return [t.detach().numpy() for t in ttrainer.tree_leaves(tree)]


def test_ensemble_step_matches_jax_vmap():
    """One step of JAX's vmapped chunk on three members with their own rhos
    against the port's ensemble step from the same states, fed JAX's new
    batches."""
    jtr = _jax_trainer()
    jst = jens.init_ensemble_states(jtr, SEEDS, RHOS)
    tree = _jax_tree(jst)
    jnew, jm = jens.make_ensemble_chunk(jtr, 1)(jst)
    want = _jax_tree(jnew)

    ttr = _trainer()
    tst = ensemble_state_from_jax(tree, CPU, keys=SEEDS)
    assert tst.key == SEEDS and tst.rho == RHOS and tst.epoch == 0
    new_colloc = torch.from_numpy(want["colloc"])[None]
    tnew, tm = tens.make_ensemble_chunk(ttr, 1)(tst, new_colloc=new_colloc)
    assert tnew.epoch == 1 and tnew.opt_state.count == 1 and tnew.rho == RHOS
    for name in ("loss", "data_term", "res_term", "admm_misfit"):
        assert tuple(tm[name].shape) == (1, len(SEEDS))
        np.testing.assert_allclose(tm[name].numpy()[0], np.asarray(jm[name])[0], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tnew.colloc.numpy(), want["colloc"])
    for m in range(len(SEEDS)):
        for key in ("mu", "nu"):
            got = tnew.opt_state.mu if key == "mu" else tnew.opt_state.nu
            for g, w in zip(_port_leaves(got["net"]), _leaves(want[key]["net"]), strict=True):
                np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-5 * np.abs(w[m]).max(),
                                           err_msg=f"member {m} {key}")
        for g, w in zip(_port_leaves(tnew.params["net"]), _leaves(want["params"]["net"]),
                        strict=True):
            assert np.abs(g[m] - w[m]).max() <= 2 * LR * (1 + 1e-3), f"member {m} params"
        for key in ("z", "dual"):
            got = getattr(tnew.admm, key).numpy()[m]
            np.testing.assert_allclose(got, want[key][m], rtol=1e-4,
                                       atol=1e-5 * np.abs(want[key][m]).max(),
                                       err_msg=f"member {m} {key}")


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(ttrainer.tree_leaves(a), ttrainer.tree_leaves(b)))


def _assert_member_is_solo(member, solo):
    assert member.epoch == solo.epoch and member.opt_state.count == solo.opt_state.count
    assert _same(member.params, solo.params)
    assert _same([member.opt_state.mu, member.opt_state.nu], [solo.opt_state.mu, solo.opt_state.nu])
    assert _same([member.admm.z, member.admm.dual], [solo.admm.z, solo.admm.dual])
    assert torch.equal(member.colloc, solo.colloc)


SCHEDULES = {
    "adam20": {"train.epochs": 20, "train.chunk": 8},
    "hybrid10": {"train.epochs": 10, "train.chunk": 4, "optimizer.kind": "hybrid",
                 "optimizer.switch_epoch": 6, "optimizer.lbfgs.max_iters": 5},
}


@pytest.mark.parametrize("rhos", [None, RHOS], ids=["loss_rho", "rho_swept"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_member_equals_its_solo_run_bit_for_bit(schedule, rhos):
    """run_ensemble's member i against Trainer.train of seed train.seed + i
    (and loss.rho = its rho), over 20 Adam epochs and over a hybrid schedule
    that switches to L-BFGS at epoch 6."""
    ttr = _trainer(**SCHEDULES[schedule])
    seed0 = ttr.exp.train.seed
    seeds = [seed0 + i for i in range(3)]
    stacked, summaries = tens.run_ensemble(ttr, seeds, rhos=rhos)
    assert [s["epochs"] for s in summaries] == [ttr.exp.train.epochs] * 3
    members = tens.unstack_states(stacked)
    for i, member in enumerate(members):
        extra = dict(SCHEDULES[schedule], **({} if rhos is None else {"loss.rho": rhos[i]}))
        solo_tr = _trainer(**extra)
        solo, solo_summary = solo_tr.train(solo_tr.init_state(seed=seeds[i]))
        _assert_member_is_solo(member, solo)
        assert member.rho == (None if rhos is None else rhos[i])
        assert summaries[i]["rel_l2_u"] == solo_summary["rel_l2_u"]


OTHER = {
    "euler_admm": ({"model.layers": (2, 8, 8, 3)}, (1.0, 40.0)),  # tuple ADMM state
    "twosin_weak": ({}, None),  # the weak form with causal weighting, no ADMM
    "burgers_forward": ({"sampling.n_f": 48}, None),  # cosine lr, a fixed anchored batch
}


@pytest.mark.parametrize("preset", sorted(OTHER))
def test_member_loop_equals_solo_runs_on_other_presets(preset):
    """The member loop keeps each member's solo trajectory on the steps K8
    does not take: the Euler generic step (each member at its own rho), the
    weak form and the generic Burgers step; 4 Adam epochs, bit for bit."""
    extra, rhos = OTHER[preset]
    exp = override(get_preset(preset), dict(_updates(**extra), **{"train.epochs": 4,
                                                                  "train.chunk": 2}))
    ttr = ttrainer.Trainer(exp, device="cpu")
    stacked, _ = tens.run_ensemble(ttr, [1, 2], rhos=rhos)
    for i, member in enumerate(tens.unstack_states(stacked)):
        solo_tr = ttrainer.Trainer(
            override(exp, {} if rhos is None else {"loss.rho": rhos[i]}), device="cpu")
        solo, _ = solo_tr.train(solo_tr.init_state(seed=i + 1))
        assert _same([member.params, member.opt_state.mu, member.colloc],
                     [solo.params, solo.opt_state.mu, solo.colloc])
        assert (member.admm is None) == (solo.admm is None)
        if member.admm is not None:
            assert _same([member.admm.z, member.admm.dual], [solo.admm.z, solo.admm.dual])


def test_stacked_state_layout():
    """Members in lockstep; the net and Adam moments views of one (E, P)
    buffer; unstacked members views of the stacked tensors."""
    ttr = _trainer()
    stacked = tens.init_ensemble_states(ttr, SEEDS, RHOS)
    n_params = ttr.problem.spec.n_params
    for net in (stacked.params["net"], stacked.opt_state.mu["net"], stacked.opt_state.nu["net"]):
        flat = k_fused.flat_net(net, n_params)
        assert tuple(flat.shape) == (3, n_params)
        leaves = net_leaves(net)  # views of the buffer: no packing
        assert flat.data_ptr() == leaves[0].data_ptr()
        assert all(t.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
                   for t in leaves)
    members = tens.unstack_states(stacked)
    assert [m.key for m in members] == list(SEEDS) and [m.rho for m in members] == list(RHOS)
    assert members[1].params["net"][0]["W"].data_ptr() == \
        stacked.params["net"][0]["W"][1].data_ptr()
    for m, seed, rho in zip(members, SEEDS, RHOS):
        _assert_member_is_solo(m, ttr.init_state(seed=seed, rho=rho))
    # a net laid out otherwise is packed, not misread
    loose = [{k: v.clone() for k, v in layer.items()} for layer in stacked.params["net"]]
    assert torch.equal(k_fused.flat_net(loose, n_params), k_fused.flat_net(stacked.params["net"],
                                                                     n_params))
    ahead, _ = ttr._adam_step(members[1])
    with pytest.raises(ValueError, match="lockstep"):
        tens.stack_states([members[0], ahead])
    with pytest.raises(ValueError, match="rho"):
        tens.stack_states([members[0], members[1]._replace(rho=None)])


@pytest.mark.parametrize("preset", ["abgrall_admm", "twosin_weak"])
def test_selection_scores_match_jax(preset):
    """scores_at JAX's own fresh points against JAX's selection_scores (data
    term, residual mean square, score and consensus against the initial
    ensemble as the anchor), and select_member by score, consensus and rank."""
    jtr = _jax_trainer(preset)
    j0 = jens.init_ensemble_states(jtr, SEEDS)
    anchor_tree = _jax_tree(j0)
    anchor_params = jax.tree_util.tree_map(jnp.asarray, anchor_tree["params"])
    jst, _ = jens.make_ensemble_chunk(jtr, 3)(j0)
    tree = _jax_tree(jst)
    jscores = jens.selection_scores(jtr, jst, 3, seed=0, n_points=256,
                                    anchor_params=anchor_params)
    spec = jtr.problem.spec
    pts = np.array(juniform_box(jax.random.PRNGKey(0), 256, jnp.asarray(jtr.problem.lb,
                                                                          spec.dtype),
                                  jnp.asarray(jtr.problem.ub, spec.dtype), spec.dtype))

    ttr = _trainer(preset)
    tst = ensemble_state_from_jax(tree, CPU, keys=SEEDS)
    anchor = ensemble_state_from_jax(anchor_tree, CPU, keys=SEEDS).params
    tscores = tens.scores_at(ttr, tst, torch.from_numpy(pts), anchor_params=anchor)
    assert [sorted(s) for s in tscores] == [sorted(s) for s in jscores]
    for t, j in zip(tscores, jscores):
        assert t["member"] == j["member"]
        for key in ("data_term", "resid_ms", "score", "consensus"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, err_msg=key)
    for by in ("score", "consensus", "rank"):
        assert tens.select_member(tscores, by) == jens.select_member(jscores, by)
        assert tens.select_member(jscores, by) == jens.select_member(jscores, by)
    with pytest.raises(ValueError, match="consensus"):
        tens.select_member([{k: v for k, v in s.items() if k != "consensus"} for s in tscores],
                           "rank")
    # the port's own draw: one batch of n_points shared by the members
    own = tens.selection_scores(ttr, tst, 3, seed=0, n_points=128)
    assert len(own) == 3 and all(math.isfinite(s["score"]) and "consensus" not in s for s in own)


def _cli(argv, capsys):
    rc = cli.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return rc, lines


TRAIN = ["train", "--preset", "abgrall_admm", "--device", "cpu", "--data", GRID,
         "--epochs", "6", "--chunk", "2", "--set", f"model.layers={LAYERS}",
         "--set", f"sampling.n_f={N_F}", "--set", f"data.n_u={N_U}",
         "--set", "optimizer.kind=hybrid", "--set", "optimizer.switch_epoch=4",
         "--set", "optimizer.lbfgs.max_iters=3", "--set", "train.checkpoint_every=2",
         "--set", "train.log_every=2"]


def test_cli_ensemble_writes_member_artifacts_and_resumes(tmp_path, capsys):
    """train --ensemble 3 --select writes the solo artifact set per member and
    prints each member's summary and the pick; --resume PREFIX from the
    epoch-2 set ends where the uninterrupted run ends, bit for bit."""
    whole, rest = tmp_path / "whole", tmp_path / "rest"
    rc, lines = _cli(TRAIN + ["--ensemble", "3", "--select", "--out-dir", str(whole)], capsys)
    assert rc == 0 and len(lines) == 4
    assert [ln["seed"] for ln in lines[:3]] == [1234, 1235, 1236]
    assert all(ln["epochs"] == 6 and math.isfinite(ln["rel_l2_u"]) for ln in lines[:3])
    pick = lines[3]
    assert pick["checkpoint"] == f"abgrall_admm_final_m{pick['selected_member']}.ckpt"
    assert [s["member"] for s in pick["scores"]] == [0, 1, 2]
    for i, name in enumerate(["abgrall_admm", "abgrall_admm_m1", "abgrall_admm_m2"]):
        with open(whole / f"{name}_metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert [r["epoch"] for r in records[:-1]] == [2, 4, 6]
        assert records[-1]["summary"]["member"] == i and records[-1]["summary"]["seed"] == 1234 + i
        for tag in ("e2", "e4", "e6", "final"):
            assert (whole / f"abgrall_admm_{tag}_m{i}.ckpt").exists()
        assert ckpt_io.load_meta(str(whole / f"abgrall_admm_final_m{i}.ckpt"))["epoch"] == 6
    rc, _ = _cli(TRAIN + ["--ensemble", "3", "--resume", str(whole / "abgrall_admm_e2"),
                          "--out-dir", str(rest)], capsys)
    assert rc == 0
    for i in range(3):
        a, b = (ckpt_io.load_checkpoint(str(d / f"abgrall_admm_final_m{i}.ckpt"), "cpu")
                for d in (whole, rest))
        _assert_member_is_solo(a, b)
    with pytest.raises(SystemExit, match="missing member checkpoint"):
        cli.main(TRAIN + ["--ensemble", "4", "--resume", str(whole / "abgrall_admm_e2")])
    with pytest.raises(SystemExit, match="--ensemble"):
        cli.main(TRAIN + ["--select"])


def test_member_table_bits():
    """K8's per-member scalars: the seed's words and float32 rho and
    threshold, rounded as a solo call rounds them."""
    seeds, rhos = (1234, 2**40 + 7, 0), (10.0, 33.3, 1e-3)
    tab = k_fused.member_table(seeds, rhos, N_F, CPU).numpy().view(np.uint32)
    for row, seed, rho in zip(tab, seeds, rhos):
        assert int(row[0]) + (int(row[1]) << 32) == seed
        assert row[2:3].view(np.float32)[0] == np.float32(rho)
        assert row[3:4].view(np.float32)[0] == np.float32(1.0 / (rho * N_F))
    with pytest.raises(ValueError, match="rhos"):
        k_fused.member_table(seeds, rhos[:2], N_F, CPU)


def _k8_args(problem, n, n_table=None):
    n_params = problem.spec.n_params
    flat = torch.zeros(n, n_params)
    return (problem.spec, flat, flat, flat, 0, problem.x_data, problem.targets["u"],
            torch.zeros(n, N_F, 2), torch.zeros(n, N_F, 1), torch.ones(n, N_F, 1),
            k_fused.member_table(SEEDS[:n_table or n] * 4, RHOS[:n_table or n] * 4, N_F,
                                 CPU)[:n_table or n])


def test_k8_wrapper_raises():
    """K8's wrapper launches on CUDA tensors only, and refuses members that
    do not match, a member table of another length and the wide design;
    it counts nothing it did not launch."""
    problem = _trainer().problem
    cfg = dict(kind="admm", lam1=1.0, lam2=0.0, lr=LR, explicit_inner=False, epoch=1)
    before = (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_fused.fused_adam_ensemble_step(*_k8_args(problem, 3), **cfg)
    args = list(_k8_args(problem, 3))
    args[7] = torch.zeros(2, N_F, 2)  # colloc of two members for three
    with pytest.raises(ValueError, match="colloc"):
        k_fused.fused_adam_ensemble_step(*args, **cfg)
    with pytest.raises(ValueError, match="member table"):
        k_fused.fused_adam_ensemble_step(*_k8_args(problem, 3, n_table=2), **cfg)
    wide = _trainer(**{"model.layers": (2, 40, 40, 1)}).problem
    args = list(_k8_args(wide, 3))
    with pytest.raises(ValueError, match="narrow design"):
        k_fused.fused_adam_ensemble_step(*args, **cfg)
    assert (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES) == before
    # the step factory: K3's scope and the narrow widths, else the member loop
    with pytest.raises(NotImplementedError, match="wide design"):
        k_fused.make_fused_ensemble_step(wide, LR)
    outside = _trainer(**{"sampling.strategy": "fixed_uniform"}).problem
    with pytest.raises(NotImplementedError, match="outside the fused CUDA step"):
        k_fused.make_fused_ensemble_step(outside, LR)
    assert not tens.batched_on_card(_trainer())


def test_later_slices_raise():
    """A device mesh (slice 6) raises naming its slice; RAD, which the solo
    trainer takes since slice 2b-iii, raises in an ensemble with the JAX
    package's own refusal (pinns_tpu/parallel/ensemble.py:75-80), as JAX's
    ensemble does."""
    ttr = _trainer()
    with pytest.raises(NotImplementedError, match="slice 6"):
        tens.run_ensemble(ttr, SEEDS[:2], mesh=object())
    ttrainer.check_slice(_exp(**{"sampling.strategy": "rad"}))
    rad = copy.copy(ttr)
    rad.exp = _exp(**{"sampling.strategy": "rad"})
    with pytest.raises(ValueError, match="not wired into the vmapped ensemble loop") as err:
        tens.make_ensemble_chunk(rad, 1)
    jrad = copy.copy(ttr)
    jrad.exp = joverride(JPRESETS["abgrall_admm"], {"sampling.strategy": "rad"})
    with pytest.raises(ValueError) as jerr:
        jens.make_ensemble_chunk(jrad, 1)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="phase"):
        tens.make_ensemble_chunk(ttr, 1, "sgd")
    # ensembles themselves are inside the port now
    ttrainer.check_slice(_exp(**{"mesh.ensemble": 4}))
    with pytest.raises(NotImplementedError, match="slice 6"):
        ttrainer.check_slice(_exp(**{"mesh.data_parallel": 2}))
