"""Port parity for RAD resampling (``sampling.strategy='rad'``) and SWA tail
averaging (``train.swa_frac``), the rest of slice 2b-iii.

RAD: the sampling weights p on the same pool against JAX's (the committed
fixture, ``scripts/make_torch_slice2b_fixture.py``, and a live JAX call),
the categorical draw's frequencies against p by a chi-square test at a fixed
seed, ADMM re-initialised at the new points, the batch fixed within a chunk
and redrawn at JAX's chunk boundaries, the CLI, and the ensemble's refusal
(JAX's own). SWA: the running mean against JAX's ``_swa_update`` sequence,
the trainer's summary and checkpoint, the CLI, and an ensemble's members
against their solo runs.

Tolerances, each with its reason: p rtol 1e-5 (the same float32 residuals
in another operation order, then |f|^k / mean), or for the weak-form cells,
whose residuals cancel, the float64 criterion (the port's error against
float64 at most 4x JAX's plus 1e-6 max|exact|); the SWA mean within float32
rounding (rtol 1e-6 of each leaf: the same float32 operations); the
chi-square test at p-value 1e-3; an ensemble's members bit for bit (each
member runs its solo run's arithmetic).
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pinns_tpu.config import override as joverride
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch import interop
from pinns_tpu_torch.config import override
from pinns_tpu_torch.data.sampling import philox_uniform
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "slice2b_rest.npz")
_spec = importlib.util.spec_from_file_location(
    "make_torch_slice2b_fixture", os.path.join(REPO, "scripts", "make_torch_slice2b_fixture.py"))
fixture_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_script)
TINY = {"model.layers": (2, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 32}


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _params(tp, seed, dtype=torch.float32):
    net = fixture_script.numpy_net(tp.spec.widths, seed)
    coeffs = {"lambda1": torch.full((1,), tp.exp.pde.lambda1, dtype=dtype),
              "lambda2": torch.full((1,), tp.exp.pde.lambda2, dtype=dtype)}
    return {"net": interop.params_from_jax(net, CPU), "coeffs": coeffs}, net


# -- RAD -----------------------------------------------------------------------

@pytest.mark.parametrize("preset", fixture_script.RAD_PRESETS)
def test_rad_probabilities_equal_jax_on_the_same_pool(fx, preset):
    """p on the fixture's pool (abgrall_l2: 8x200 strong form; hwan_admm:
    8x20 ADMM; twosin_weak: the weak-form cells) against JAX's."""
    tp = ttrainer.build_problem(override(get_preset(preset), {"sampling.strategy": "rad"}), "cpu")
    p_ = f"rad_{preset}_"
    params, _ = _params(tp, int(fx[p_ + "seed"]))
    with torch.no_grad():
        p = ttrainer.rad_probabilities(tp, params, torch.from_numpy(fx[p_ + "pool"]))
    assert p.shape == (fx[p_ + "pool"].shape[0],) and p.dtype == torch.float32
    want = fx[p_ + "p"]
    if tp.flux and not np.allclose(p.numpy(), want, rtol=1e-5, atol=0):
        # a cell residual is a difference quotient of edge means that
        # cancels: the float64 criterion (the port's error against float64
        # at most 4x JAX's)
        tp64 = ttrainer.build_problem(override(get_preset(preset), {
            "sampling.strategy": "rad", "model.dtype": "float64"}), "cpu")
        params64 = ttrainer.tree_map(lambda t: t.double(), params)
        with torch.no_grad():
            exact = ttrainer.rad_probabilities(tp64, params64,
                                               torch.from_numpy(fx[p_ + "pool"]).double())
        exact = exact.numpy()
        err, jax_err = np.abs(p.numpy() - exact).max(), np.abs(want - exact).max()
        assert err <= 4.0 * jax_err + 1e-6 * np.abs(exact).max(), (err, jax_err)
        return
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-5, atol=0)


def test_rad_probabilities_equal_live_jax_with_microbatches():
    """p with microbatched scoring (microbatch x rad_pool_factor pieces)
    against JAX's formula on the same pool at a small net."""
    upd = dict(TINY, **{"sampling.strategy": "rad", "sampling.microbatch": 2,
                        "sampling.rad_k": 2.0, "sampling.rad_c": 0.5})
    tp = ttrainer.build_problem(override(get_preset("abgrall_admm"), upd), "cpu")
    jp = jtrainer.build_problem(joverride(JPRESETS["abgrall_admm"], upd))
    params, net = _params(tp, 3)
    pool = np.random.default_rng(4).uniform(tp.lb, tp.ub, (1024, 2)).astype(np.float32)
    with torch.no_grad():
        p = ttrainer.rad_probabilities(tp, params, torch.from_numpy(pool))
    jparams = {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net],
               "coeffs": {k: jnp.asarray(v.numpy()) for k, v in params["coeffs"].items()}}
    f = jp.residuals(jparams, jnp.asarray(pool))
    pk = jnp.abs(f[:, 0]) ** 2.0
    want = pk / (jnp.mean(pk) + 1e-12) + 0.5
    np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def test_rad_draw_frequencies_follow_p():
    """The categorical draw (rad_pick at Philox uniforms) against p by a
    chi-square test over 40 categories, 200,000 draws, at a fixed seed."""
    p = torch.from_numpy(np.random.default_rng(8).uniform(0.1, 3.0, 40).astype(np.float32))
    u = philox_uniform(1234, ttrainer.RAD_PICK + 5, 200_000, (0.0, 0.0), (1.0, 1.0))[:, 0]
    idx = ttrainer.rad_pick(p, u)
    counts = np.bincount(idx.numpy(), minlength=40)
    expect = 200_000 * p.double().numpy() / p.double().sum().item()
    assert stats.chisquare(counts, expect).pvalue > 1e-3
    assert int(idx.min()) >= 0 and int(idx.max()) < 40


def test_rad_resample_redraws_from_the_pool_by_p():
    """rad_resample: n_f points of the Philox pool in the curriculum's
    bounds, drawn by p (a chi-square test over p's deciles), ADMM re-
    initialised at them (z = r, dual = 1)."""
    upd = dict(TINY, **{"sampling.strategy": "rad", "sampling.n_f": 2048,
                        "sampling.rad_pool_factor": 4})
    trainer = ttrainer.Trainer(override(get_preset("hwan_admm"), upd), device="cpu")
    tp = trainer.problem
    state = trainer.init_state()
    state = state._replace(epoch=7)
    new = ttrainer.rad_resample(tp, state)
    lb, ub = ttrainer._curriculum_bounds(tp, 7)
    pool = philox_uniform(state.key, ttrainer.RAD_POOL + 7, 4 * 2048, lb, ub)
    assert new.colloc.shape == (2048, 2)
    # every drawn point is a pool point
    idx = torch.cdist(new.colloc.double(), pool.double(),
                      compute_mode="donot_use_mm_for_euclid_dist").argmin(dim=1)
    assert torch.equal(pool.index_select(0, idx), new.colloc)
    with torch.no_grad():
        p = ttrainer.rad_probabilities(tp, state.params, pool).double()
    edges = torch.quantile(p, torch.linspace(0, 1, 11, dtype=torch.float64))
    bins = torch.bucketize(p, edges[1:-1])
    mass = torch.zeros(10, dtype=torch.float64).index_add_(0, bins, p)
    counts = np.bincount(bins[idx].numpy(), minlength=10)
    assert stats.chisquare(counts, (2048 * mass / mass.sum()).numpy()).pvalue > 1e-3
    z = tp.training_residuals(state.params, new.colloc)
    assert torch.equal(new.admm.z, z)
    assert torch.equal(new.admm.dual, torch.ones_like(z))
    again = ttrainer.rad_resample(tp, state)
    assert torch.equal(again.colloc, new.colloc)


def test_rad_batches_fixed_within_a_chunk_and_redrawn_at_jax_boundaries(monkeypatch):
    """The port redraws at the epochs JAX's trainer does (train.chunk,
    clipped at switch_epoch, none after the last chunk), and the batch is
    fixed within a chunk."""
    upd = dict(TINY, **{"sampling.strategy": "rad", "train.chunk": 3, "train.epochs": 10,
                        "optimizer.kind": "hybrid", "optimizer.switch_epoch": 5,
                        "optimizer.lbfgs.max_iters": 2, "train.log_every": 0})
    seen_port, seen_jax = [], []
    orig = ttrainer.rad_resample

    def spy(problem, state, plain=False):
        seen_port.append(int(state.epoch))
        return orig(problem, state, plain)

    monkeypatch.setattr(ttrainer, "rad_resample", spy)
    trainer = ttrainer.Trainer(override(get_preset("abgrall_admm"), upd), device="cpu")
    state = trainer.init_state()
    colloc0 = state.colloc.clone()
    s3, _ = ttrainer.run_chunk(trainer._adam_step, state, 3)
    assert torch.equal(s3.colloc, colloc0)
    trainer.train(state)
    jtr = jtrainer.Trainer(joverride(JPRESETS["abgrall_admm"], upd))
    jfn = jtr._get_rad_resample()
    jtr._rad_fn = lambda st: (seen_jax.append(int(st.epoch)), jfn(st))[1]
    jtr.train()
    assert seen_port == seen_jax == [3, 5, 6, 7, 8, 9]


def test_rad_trains_from_the_cli(tmp_path):
    from pinns_tpu_torch import cli

    out = tmp_path / "run"
    rc = cli.main(["train", "--preset", "abgrall_admm", "--device", "cpu", "--epochs", "4",
                   "--out-dir", str(out), "--set", "sampling.strategy=rad",
                   "--set", "model.layers=(2, 8, 1)", "--set", "sampling.n_f=32",
                   "--set", "data.n_u=16", "--set", "train.chunk=2"])
    assert rc in (0, None)
    state = ckpt_io.load_checkpoint(str(out / "abgrall_admm_final.ckpt"), "cpu")
    assert state.colloc.shape == (32, 2) and torch.isfinite(state.admm.z).all()


def test_rad_in_an_ensemble_raises_jax_s_refusal():
    from pinns_tpu.parallel import ensemble as jens

    trainer = ttrainer.Trainer(override(get_preset("abgrall_admm"), dict(
        TINY, **{"sampling.strategy": "rad", "train.epochs": 2})), device="cpu")
    with pytest.raises(ValueError) as err:
        tens.run_ensemble(trainer, (1, 2))
    jtr = copy.copy(trainer)
    jtr.exp = joverride(JPRESETS["abgrall_admm"], {"sampling.strategy": "rad"})
    with pytest.raises(ValueError) as jerr:
        jens.make_ensemble_chunk(jtr, 1)
    assert str(err.value) == str(jerr.value) == tens.RAD_REFUSAL


# -- SWA -----------------------------------------------------------------------

def test_swa_mean_equals_jax_sequence(fx):
    """The running mean over the fixture's snapshots against JAX's
    ``_swa_update`` after each."""
    layers = tuple(int(w) for w in fx["swa_layers"])
    seed = int(fx["swa_seed"])
    avg, n = None, 0
    for i in range(fixture_script.SWA_SNAPSHOTS):
        net = interop.params_from_jax(fixture_script.numpy_net(layers, seed + i), CPU)
        avg, n = ttrainer.swa_update(avg, n, {"net": net})
        got = torch.cat([t.reshape(-1) for t in k_taylor2.net_leaves(avg["net"])]).numpy()
        np.testing.assert_allclose(got, fx[f"swa_mean_{i}"], rtol=1e-6, atol=0,
                                   err_msg=f"snapshot {i}")
        assert avg["net"][0]["W"].dtype == torch.float32
    assert n == fixture_script.SWA_SNAPSHOTS


def test_swa_summary_and_checkpoint(tmp_path):
    """train with swa_frac: the mean over the chunk boundaries past the
    start (JAX's rule), swa_snapshots and swa_* in the summary, the swa
    checkpoint holding the averaged params."""
    upd = dict(TINY, **{"train.swa_frac": 0.5, "train.epochs": 8, "train.chunk": 2,
                        "train.out_dir": str(tmp_path), "train.log_every": 0})
    trainer = ttrainer.Trainer(override(get_preset("abgrall_admm"), upd), device="cpu")
    snaps = []
    orig = ttrainer.swa_update

    def spy(avg, n, params):
        snaps.append(ttrainer.tree_map(torch.clone, params))
        return orig(avg, n, params)

    ttrainer.swa_update, saved = spy, ttrainer.swa_update
    try:
        state, summary = trainer.train()
    finally:
        ttrainer.swa_update = saved
    assert summary["swa_snapshots"] == len(snaps) == 2  # the boundaries 6 and 8, past 4
    mean = [sum(k_taylor2.net_leaves(s["net"])[i].double() for s in snaps) / len(snaps)
            for i in range(len(k_taylor2.net_leaves(state.params["net"])))]
    got = k_taylor2.net_leaves(trainer.swa_params["net"])
    for g, m in zip(got, mean):
        np.testing.assert_allclose(g.numpy(), m.numpy(), rtol=1e-6, atol=1e-7)
    assert "swa_rel_l2_u" in summary
    swa = ckpt_io.load_checkpoint(str(tmp_path / "abgrall_admm_swa.ckpt"), "cpu")
    for a, b in zip(k_taylor2.net_leaves(swa.params["net"]), got):
        assert torch.equal(a, b)


def test_swa_trains_from_the_cli(tmp_path):
    from pinns_tpu_torch import cli

    out = tmp_path / "run"
    rc = cli.main(["train", "--preset", "twosin_weak", "--device", "cpu", "--epochs", "4",
                   "--out-dir", str(out), "--set", "train.swa_frac=0.5",
                   "--set", "model.layers=(2, 8, 1)", "--set", "sampling.n_f=32",
                   "--set", "data.n_u=16", "--set", "train.chunk=1"])
    assert rc in (0, None)
    assert os.path.exists(out / "twosin_weak_swa.ckpt")


def test_swa_ensemble_members_equal_solo_runs(tmp_path):
    """run_ensemble with swa_frac: each member's SWA params and summary
    entries equal its solo Trainer.train's bit for bit."""
    upd = dict(TINY, **{"train.swa_frac": 0.5, "train.epochs": 6, "train.chunk": 2,
                        "train.log_every": 0})
    exp = override(get_preset("abgrall_admm"), upd)
    trainer = ttrainer.Trainer(override(exp, {"train.out_dir": str(tmp_path)}), device="cpu")
    _, summaries = tens.run_ensemble(trainer, (11, 12))
    for i, seed in enumerate((11, 12)):
        solo = ttrainer.Trainer(override(exp, {"train.seed": seed}), device="cpu")
        _, s = solo.train()
        assert summaries[i]["swa_snapshots"] == s["swa_snapshots"]
        assert summaries[i]["swa_rel_l2_u"] == s["swa_rel_l2_u"]
        member = ckpt_io.load_checkpoint(str(tmp_path / f"abgrall_admm_swa_m{i}.ckpt"), "cpu")
        for a, b in zip(k_taylor2.net_leaves(member.params["net"]),
                        k_taylor2.net_leaves(solo.swa_params["net"])):
            assert torch.equal(a, b)
