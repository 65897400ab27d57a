"""The port on the card: the fused Taylor-2 kernel (K1) and its backward
(K2), the fused MLP forward and its backward (K5), the served slice, the
fused Adam-epoch kernel (K3, both designs, and K8, its member-batched narrow
design with the ensemble trainer), the mixed-precision Taylor-2 kernel (K6) and
its backward, the Taylor-1 kernel (K7a) and its backward with the Euler
slice, the weak-form flux quadrature (K7b) with its presets, and the trainer with its generic Adam step (microbatched, under the
stream policy) and L-BFGS phase over the kernels.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda``, and skips
where ``torch.cuda.is_available()`` is False. The file imports no jax (the
GPU machine has none), so it also runs without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import mlp_taylor_2, mlp_taylor_2_reference
from pinns_tpu_torch.serve import ServedModel, export_predict
from pinns_tpu_torch.train.evaluate import relative_l2
from torch_port_util import FIXTURE, LB, UB, assert_close, cuda_device, numpy_points  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("layers,n", [((2,) + (20,) * 8 + (1,), 1000),
                                      ((2, 256, 256, 3), 777),
                                      ((2, 64, 1), 3)])
def test_kernel_matches_reference_on_card(cuda_device, layers, n):  # noqa: F811
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(1), cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=12)).to(cuda_device)
    before = k_taylor2.LAUNCHES
    got = mlp_taylor_2(spec, params, x)
    torch.cuda.synchronize()
    assert k_taylor2.LAUNCHES == before + 1
    # float64 oracle: the kernel is as accurate as the plain float32 recurrence
    # (random deep nets cancel too much for a max|.|-relative tolerance)
    spec64 = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    exact = mlp_taylor_2_reference(
        spec64, [{k: v.double() for k, v in p.items()} for p in params], x.double()
    )
    plain = mlp_taylor_2_reference(spec, params, x)
    for g, p, e in zip(got, plain, exact):
        assert g.shape == (n, layers[-1])
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= 4.0 * plain_err + 1e-6 * float(e.abs().max())


def test_served_model_on_card(cuda_device, tmp_path):  # noqa: F811
    loaded = load_params_npz(FIXTURE)
    art = export_predict(loaded["spec"], loaded["params"], str(tmp_path / "m"),
                         lambda1=loaded["lambda1"], lambda2=loaded["lambda2"])
    with np.load(FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in ("X_star", "u_star", "u_jax", "f_jax", "rel_l2_jax")}
    served = ServedModel(art, device=cuda_device)
    before = k_taylor2.LAUNCHES
    out = served.predict(fx["X_star"], pad_to_bucket=True)
    assert k_taylor2.LAUNCHES > before
    for k in ("u", "f"):
        assert_close(k, out[k], fx[f"{k}_jax"])
    assert abs(relative_l2(out["u"], fx["u_star"]) - float(fx["rel_l2_jax"])) <= 1e-5


WIDE = (2,) + (200,) * 8 + (1,)  # burgers_scale's and abgrall_l1's net
NARROW = (2,) + (20,) * 8 + (1,)  # abgrall_admm's net
EULER = (2,) + (200,) * 5 + (3,)  # the Euler slices' trunk


def _close_or_f64(got, plain, exact, wide):
    """The kernel within rtol 1e-4 and atol 1e-5 max|plain| of the plain
    float32 version; a wide net's value that misses it must pass the float64
    oracle instead (_f64_oracle), as chip_smoke.py's phase 7 holds it."""
    got, plain = torch.as_tensor(got).double().cpu(), torch.as_tensor(plain).double().cpu()
    ok = bool(((got - plain).abs() <= 1e-5 * float(plain.abs().max()) + 1e-4 * plain.abs()).all())
    if ok:
        return
    assert wide, (float((got - plain).abs().max()), float(plain.abs().max()))
    _f64_oracle(got, plain, torch.as_tensor(exact).double().cpu())


@pytest.mark.parametrize("layers,n_f", [((2, 16, 16, 16, 1), 77), (NARROW, 1_000), (NARROW, 4_000),
                                        ((2, 64, 64, 64, 1), 77), ((2, 64, 64, 64, 1), 1_000),
                                        (WIDE, 77), (WIDE, 1_000)],
                         ids=["16-77", "8x20-1000", "8x20-4000", "64-77", "64-1000", "8x200-77",
                              "8x200-1000"])
@pytest.mark.parametrize("kind,explicit_inner", [("admm", False), ("admm", True), ("mean_sq", False),
                                                 ("l2_sq_norm", False), ("l1_sq_norm", False)])
def test_fused_step_matches_its_reference_on_card(cuda_device, kind, explicit_inner, layers,
                                                  n_f):  # noqa: F811
    """The CUDA step's loss and gradient against the hand-written reverse mode
    in plain PyTorch on the same card, and its Adam stage and ADMM tail
    against the plain functions fed the kernel's own gradient and params; two
    calls agree bit for bit. The 16-wide net and abgrall_admm's 8x20 (at its
    N_f 1,000 and at 4,000) take the narrow design, the wider ones the wide
    design, whose values are held against float64 where they miss the plain
    version's tolerance."""
    from pinns_tpu_torch.losses.admm import ADMMState, admm_misfit, admm_update
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.opt.adam import AdamState, adam_update

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    spec64 = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    wide = k_fused.design(layers) == "wide"
    assert wide == (max(layers) > 32)
    net = init_mlp(spec, torch.Generator().manual_seed(3), cuda_device)
    net64 = [{k: v.double() for k, v in p.items()} for p in net]
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data = t(numpy_points(n_f, seed=6)), t(numpy_points(13, seed=7))
    u_data = t(rng.standard_normal((13, 1)))
    z = t(0.1 * rng.standard_normal((n_f, 1))) if kind == "admm" else None
    dual = t(1 + 0.1 * rng.standard_normal((n_f, 1))) if kind == "admm" else None
    d64 = lambda v: None if v is None else v.double()  # noqa: E731
    flat = pack_params(net)
    mu, nu = 0.01 * torch.ones_like(flat), 1e-4 * torch.ones_like(flat)
    new = t(numpy_points(n_f, seed=8))
    cfg = dict(kind=kind, lam1=0.9, lam2=0.01, rho=10.0, lr=1e-3, explicit_inner=explicit_inner)
    before = k_fused.LAUNCHES
    r = k_fused.fused_adam_step(spec, flat, mu, nu, 4, x_data, u_data, colloc, z, dual, seed=9,
                                epoch=5, new_colloc=new, want_grad=True, **cfg)
    again = k_fused.fused_adam_step(spec, flat, mu, nu, 4, x_data, u_data, colloc, z, dual,
                                    seed=9, epoch=5, new_colloc=new, want_grad=True, **cfg)
    torch.cuda.synchronize()
    assert k_fused.LAUNCHES == before + 2
    assert all(torch.equal(r[k], again[k]) for k in r if r[k] is not None)
    ref = dict(kind=kind, lam1=0.9, lam2=0.01, rho=10.0, explicit_inner=explicit_inner)
    loss, data_term, res_term, grads = k_fused.loss_and_grad_reference(
        spec, net, x_data, u_data, colloc, z, dual, **ref)
    exact = k_fused.loss_and_grad_reference(spec64, net64, x_data.double(), u_data.double(),
                                            colloc.double(), d64(z), d64(dual), **ref)
    got = r["grad"].cpu().numpy()
    off = 0
    for g, e in zip(grads, exact[3]):
        w = g.reshape(-1).cpu().numpy()
        if wide:
            _close_or_f64(got[off:off + w.size], w, e.reshape(-1), wide)
        else:
            np.testing.assert_allclose(got[off:off + w.size], w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())
        off += w.size
    m = r["metrics"].cpu().numpy()  # trainer.METRIC_KEYS order
    if wide:
        for i, (p, e) in zip((5, 1, 6), zip((loss, data_term, res_term), exact[:3])):
            _close_or_f64(torch.tensor([float(m[i])]), torch.tensor([float(p)]),
                          torch.tensor([float(e)]), wide)
    else:
        np.testing.assert_allclose(m[[5, 1, 6]], [float(loss), float(data_term), float(res_term)],
                                   rtol=1e-4)
    upd, adam = adam_update(r["grad"], AdamState(4, mu, nu), 1e-3)
    np.testing.assert_allclose(r["params"].cpu().numpy(), (flat + upd).cpu().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(r["colloc"], new)
    if kind == "admm":
        new_net = k_fused.unpack_params(r["params"], layers)
        uu, ux, ut, uxx = mlp_taylor_2_reference(spec, new_net, new)
        f = ut + 0.9 * uu * ux - 0.01 * uxx
        want = admm_update(f, ADMMState(z, dual), 10.0, n_f)
        u64, ux64, ut64, uxx64 = mlp_taylor_2_reference(
            spec64, [{k: v.double() for k, v in p.items()} for p in new_net], new.double())
        f64 = ut64 + 0.9 * u64 * ux64 - 0.01 * uxx64
        want64 = admm_update(f64, ADMMState(z.double(), dual.double()), 10.0, n_f)
        if wide:
            _close_or_f64(r["z"], want.z, want64.z, wide)
            _close_or_f64(torch.tensor([float(m[0])]), torch.tensor([float(admm_misfit(f, want))]),
                          torch.tensor([float(admm_misfit(f64, want64))]), wide)
        else:
            np.testing.assert_allclose(r["z"].cpu().numpy(), want.z.cpu().numpy(), rtol=1e-4,
                                       atol=1e-5 * float(want.z.abs().max()))
            np.testing.assert_allclose(m[0], float(admm_misfit(f, want)), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("layers,n_f", [(NARROW, 1_000), ((2, 16, 16, 16, 1), 77)],
                         ids=["8x20-1000", "16-77"])
def test_fused_step_tail_at_lr_0_on_card(cuda_device, layers, n_f):  # noqa: F811
    """At lr 0 the narrow step leaves the params as they are, so its tail
    runs at the params it was given: the drawn points equal the Philox
    reference (data.sampling.philox_uniform) bit for bit, and z, dual and
    the misfit agree with the plain ADMM update at those params and points
    within the fused-step test's tolerances (z and the misfit rtol 1e-4 /
    atol 1e-5 max|z|; dual atol 1e-5 of max|dual| + rho max|z|, the scale
    it is built from)."""
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.losses.admm import ADMMState, admm_misfit, admm_update
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    assert k_fused.design(layers) == "narrow"
    net = init_mlp(spec, torch.Generator().manual_seed(4), cuda_device)
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data = t(numpy_points(n_f, seed=6)), t(numpy_points(100, seed=7))
    u_data = t(rng.standard_normal((100, 1)))
    z, dual = t(0.1 * rng.standard_normal((n_f, 1))), t(1 + 0.1 * rng.standard_normal((n_f, 1)))
    flat = pack_params(net)
    mu, nu = 0.01 * torch.ones_like(flat), 1e-4 * torch.ones_like(flat)
    seed, epoch, rho = 2**33 + 9, 5, 10.0
    r = k_fused.fused_adam_step(spec, flat, mu, nu, 4, x_data, u_data, colloc, z, dual,
                                kind="admm", lam1=0.9, lam2=0.01, rho=rho, lr=0.0,
                                explicit_inner=False, seed=seed, epoch=epoch)
    torch.cuda.synchronize()
    assert torch.equal(r["params"], flat)
    assert torch.equal(r["colloc"], philox_uniform(seed, epoch, n_f, LB, UB, device=cuda_device))
    uu, ux, ut, uxx = mlp_taylor_2_reference(spec, net, r["colloc"])
    f = ut + 0.9 * uu * ux - 0.01 * uxx
    want = admm_update(f, ADMMState(z, dual), rho, n_f)
    zmax = float(want.z.abs().max())
    np.testing.assert_allclose(r["z"].cpu().numpy(), want.z.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * zmax)
    np.testing.assert_allclose(r["dual"].cpu().numpy(), want.dual.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * (float(dual.abs().max()) + rho * zmax))
    np.testing.assert_allclose(float(r["metrics"][0]), float(admm_misfit(f, want)), rtol=1e-4,
                               atol=1e-7)


def test_fused_step_refuses_a_plan_that_does_not_fit(cuda_device, monkeypatch):  # noqa: F811
    """The wide K3 lays out its scratch itself: a plan with less scratch than
    that layout needs, a split that straddles the two segments, a tile it
    does not instantiate, or a padding short of the points raises and counts
    no call."""
    import dataclasses

    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    spec = MLPSpec(layers=WIDE, lb=LB, ub=UB)
    flat = pack_params(init_mlp(spec, torch.Generator().manual_seed(3), cuda_device))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data, u_data = t(numpy_points(1_000, 6)), t(numpy_points(100, 7)), t(np.ones((100, 1)))
    plan = k_fused.step_plan(WIDE, 1_000, 100)
    assert plan.design == "wide"
    before = k_fused.LAUNCHES
    for bad in (dataclasses.replace(plan, grad=plan.grad - 4),
                dataclasses.replace(plan, split_rows=plan.split_rows + 8),
                dataclasses.replace(plan, tile=64),
                dataclasses.replace(plan, tile=128),
                dataclasses.replace(plan, nf_pad=plan.nf_pad - 128)):
        monkeypatch.setattr(k_fused, "step_plan", lambda *args, bad=bad: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k_fused.fused_adam_step(spec, flat, flat, flat, 1, x_data, u_data, colloc, None, None,
                                    kind="l1_sq_norm", lam1=1.0, lam2=0.0, rho=10.0, lr=1e-3,
                                    explicit_inner=False, seed=1, epoch=1)
    assert k_fused.LAUNCHES == before


def test_fused_step_refuses_a_narrow_tile_that_does_not_fit(cuda_device, monkeypatch):  # noqa: F811
    """The narrow K3 runs a thread a (point, unit) of a layer in blocks of
    256 threads: a tile of more points than that holds at the net's width,
    or none, raises and counts no call."""
    import dataclasses

    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    spec = MLPSpec(layers=NARROW, lb=LB, ub=UB)
    flat = pack_params(init_mlp(spec, torch.Generator().manual_seed(3), cuda_device))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data, u_data = t(numpy_points(1_000, 6)), t(numpy_points(100, 7)), t(np.ones((100, 1)))
    plan = k_fused.step_plan(NARROW, 1_000, 100)
    assert plan.design == "narrow"
    before = k_fused.LAUNCHES
    for bad in (dataclasses.replace(plan, tile=16), dataclasses.replace(plan, tail_tile=16),
                dataclasses.replace(plan, tile=0)):
        monkeypatch.setattr(k_fused, "step_plan", lambda *args, bad=bad: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k_fused.fused_adam_step(spec, flat, flat, flat, 1, x_data, u_data, colloc, None, None,
                                    kind="l1_sq_norm", lam1=1.0, lam2=0.0, rho=10.0, lr=1e-3,
                                    explicit_inner=False, seed=1, epoch=1)
    assert k_fused.LAUNCHES == before


def test_trainer_on_card_runs_the_fused_step(cuda_device):  # noqa: F811
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {"train.epochs": 30, "train.chunk": 10,
                                                "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    before = (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS, k_fused.GRAPH_REPLAYS)
    state, summary = trainer.train()
    # K9: every epoch inside a replay of the captured graphs, no host call
    assert (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS, k_fused.GRAPH_REPLAYS) == (
        before[0], before[1] + 30, before[2] + 15) and state.epoch == 30
    assert np.isfinite(summary["rel_l2_u"])
    # outside K3's scope the trainer takes the generic step over K5, K1 and K2
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    counts = lambda: (k_fused.LAUNCHES, k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES,  # noqa: E731
                      k_taylor2.LAUNCHES, k_taylor2.BACKWARD_LAUNCHES)
    before = counts()
    generic = Trainer(override(exp, {"sampling.strategy": "fixed_uniform"}), device="cuda")
    state, summary = generic.train()
    after = counts()
    assert after[0] == before[0] and state.epoch == 30 and np.isfinite(summary["rel_l2_u"])
    assert all(a >= b + 30 for a, b in zip(after[1:], before[1:]))


@pytest.mark.parametrize("kind", ["admm", "l1_sq_norm"])
def test_k8_members_equal_solo_k3_on_card(cuda_device, kind):  # noqa: F811
    """K8 over three members with their own seeds and rhos, two chained
    epochs: every output of member m equal to a solo K3 call of member m bit
    for bit, one host call an epoch."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    layers, n_f, n = (2, 16, 16, 16, 1), 77, 3
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    seeds, rhos = [9, 10, 2**33 + 11], [1.0, 10.0, 40.0]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    rng = np.random.default_rng(5)
    x_data, u_data = t(numpy_points(13, seed=7)), t(rng.standard_normal((13, 1)))
    flat = torch.stack([pack_params(init_mlp(spec, torch.Generator().manual_seed(3 + m),
                                             cuda_device)) for m in range(n)])
    cur = {"params": flat, "mu": torch.zeros_like(flat), "nu": torch.zeros_like(flat),
           "colloc": torch.stack([t(numpy_points(n_f, seed=6 + m)) for m in range(n)]),
           "z": t(0.1 * rng.standard_normal((n, n_f, 1))) if kind == "admm" else None,
           "dual": t(np.ones((n, n_f, 1))) if kind == "admm" else None}
    solo = [{k: None if v is None else v[m].clone() for k, v in cur.items()} for m in range(n)]
    cfg = dict(kind=kind, lam1=0.9, lam2=0.01, lr=1e-3, explicit_inner=False)
    table = k_fused.member_table(seeds, rhos, n_f, cuda_device)
    before = (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES)
    for epoch in (1, 2):
        r8 = k_fused.fused_adam_ensemble_step(
            spec, cur["params"], cur["mu"], cur["nu"], epoch - 1, x_data, u_data, cur["colloc"],
            cur["z"], cur["dual"], table, epoch=epoch, want_grad=True, **cfg)
        rs = [k_fused.fused_adam_step(spec, s["params"], s["mu"], s["nu"], epoch - 1, x_data,
                                      u_data, s["colloc"], s["z"], s["dual"], rho=rhos[m],
                                      seed=seeds[m], epoch=epoch, want_grad=True, **cfg)
              for m, s in enumerate(solo)]
        torch.cuda.synchronize()
        for m in range(n):
            for k, v in r8.items():
                if v is not None:
                    assert torch.equal(v[m], rs[m][k]), (epoch, m, k)
        cur = {k: r8[k] for k in cur}
        solo = [{k: rs[m][k] for k in cur} for m in range(n)]
    assert (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES) == (before[0] + 2, before[1] + 2 * n)


def test_ensemble_trainer_on_card_runs_k8(cuda_device, tmp_path):  # noqa: F811
    """run_ensemble on the card: the Adam epochs of abgrall_admm's members
    in one K8 call each; each member equal to its solo run bit for bit."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train.trainer import Trainer, tree_leaves

    exp = override(get_preset("abgrall_admm"), {"train.epochs": 30, "train.chunk": 10,
                                                "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    assert ens.batched_on_card(trainer)
    before = (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS)
    stacked, summaries = ens.run_ensemble(trainer, [1234, 7, 99], rhos=[10.0, 20.0, 40.0])
    # K9 over K8: every Adam epoch of all members inside a replay
    assert (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS) == (
        before[0], before[1], before[2] + 30)
    for member, seed, rho, summary in zip(ens.unstack_states(stacked), [1234, 7, 99],
                                          [10.0, 20.0, 40.0], summaries):
        solo_tr = Trainer(override(exp, {"loss.rho": rho}), device="cuda")
        solo, solo_summary = solo_tr.train(solo_tr.init_state(seed=seed))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves([member.params, member.admm.z, member.colloc]),
            tree_leaves([solo.params, solo.admm.z, solo.colloc])))
        assert summary["rel_l2_u"] == solo_summary["rel_l2_u"]


def _state_tensors(state):
    """A state's tensors and its chunk's metrics, by name, for torch.equal."""
    from pinns_tpu_torch.ops.kernels.fused_step import flat_net

    opt = state.opt_state
    n = sum(layer["W"].shape[-2] * layer["W"].shape[-1] + layer["b"].shape[-1]
            for layer in state.params["net"])
    out = {"params": flat_net(state.params["net"], n), "mu": flat_net(opt.mu["net"], n),
           "nu": flat_net(opt.nu["net"], n), "colloc": state.colloc}
    if state.admm is not None:
        out.update(z=state.admm.z, dual=state.admm.dual)
    return out


def _assert_same_chunk(a, b):
    (sa, ma), (sb, mb) = a, b
    assert (sa.epoch, sa.opt_state.count) == (sb.epoch, sb.opt_state.count)
    ta, tb = _state_tensors(sa), _state_tensors(sb)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


@pytest.mark.parametrize("layers,kind", [((2,) + (20,) * 8 + (1,), "admm"),
                                         ((2, 16, 16, 16, 1), "l1_sq_norm"),
                                         ((2, 40, 40, 40, 1), "admm"),
                                         ((2, 40, 40, 40, 1), "l1_sq_norm")],
                         ids=["8x20-admm", "16-l1", "40-admm", "40-l1"])
def test_graphed_chunk_equals_the_loop_on_card(cuda_device, layers, kind):  # noqa: F811
    """K9: the fused step's chunk replayed from captured graphs (narrow and
    wide designs) equals the per-epoch loop bit for bit on every tensor and
    metrics row, at odd and even lengths, split or whole, fed or drawn; its
    epochs run in replays, with no host call of the step."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("abgrall_admm"), {
        "model.layers": layers, "loss.residual_kind": kind, "sampling.n_f": 200,
        "train.chunk": 8})
    trainer = tr.Trainer(exp, device="cuda")
    assert k_fused.design(layers) == ("wide" if max(layers) > 32 else "narrow")
    run = trainer._get_chunk("adam")
    state = trainer.init_state()
    for length in (1, 2, 7):
        before = (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS)
        got = run(state, length)
        assert (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS) == (before[0], before[1] + length)
        _assert_same_chunk(got, tr.run_chunk(trainer._adam_step, state, length))
    half, _ = run(state, 3)
    _assert_same_chunk(run(half, 3), tr.run_chunk(trainer._adam_step, half, 3))
    whole, _ = run(state, 6)
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(run(half, 3)[0]).values(),
                                                  _state_tensors(whole).values()))
    feed = torch.from_numpy(np.stack([numpy_points(200, seed=s) for s in range(5)])).to(
        cuda_device)
    _assert_same_chunk(run(state, 5, new_colloc=feed),
                       tr.run_chunk(trainer._adam_step, state, 5, new_colloc=feed))
    # a longer chunk than the runner holds reallocates and captures anew;
    # another seed captures anew
    _assert_same_chunk(run(state, 11), tr.run_chunk(trainer._adam_step, state, 11))
    other = trainer.init_state(seed=7)
    _assert_same_chunk(run(other, 3), tr.run_chunk(trainer._adam_step, other, 3))
    # the returned state is the caller's: writing into it leaves the next chunk alone
    out, _ = run(state, 2)
    _state_tensors(out)["params"].add_(1.0)
    _assert_same_chunk(run(state, 2), tr.run_chunk(trainer._adam_step, state, 2))


@pytest.mark.parametrize("n", [1, 3])
def test_graphed_k8_chunk_equals_the_loop_on_card(cuda_device, n):  # noqa: F811
    """K9 over K8: an ensemble's chunk replayed from captured graphs equals
    the per-epoch K8 loop bit for bit, members of distinct seeds and rhos,
    with and without given points; another ensemble's seeds and rhos go
    through the member table without a new capture."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("abgrall_admm"), {"sampling.n_f": 200, "train.chunk": 8})
    trainer = tr.Trainer(exp, device="cuda")
    k8 = k_fused.make_fused_ensemble_step(trainer.problem, trainer.learning_rate)
    loop = lambda stacked, length, feed=None: tr.run_chunk(k8, stacked, length, feed)  # noqa: E731

    stacked = ens.init_ensemble_states(trainer, [1234 + i for i in range(n)],
                                       [10.0 * (i + 1) for i in range(n)])
    for length in (1, 4, 7):
        before = (k_fused.ENSEMBLE_LAUNCHES, k_fused.GRAPH_EPOCHS)
        got = ens.make_ensemble_chunk(trainer, length)(stacked)
        assert (k_fused.ENSEMBLE_LAUNCHES, k_fused.GRAPH_EPOCHS) == (before[0],
                                                                     before[1] + length)
        _assert_same_chunk(got, loop(stacked, length))
    feed = torch.from_numpy(np.stack([[numpy_points(200, seed=10 * t + m) for m in range(n)]
                                      for t in range(3)])).to(cuda_device)
    _assert_same_chunk(ens.make_ensemble_chunk(trainer, 3)(stacked, new_colloc=feed),
                       loop(stacked, 3, feed))
    runner = ens.k8_chunk(trainer, n)
    captures = len(runner.capture_seconds)
    other = ens.init_ensemble_states(trainer, [99 + i for i in range(n)],
                                     [40.0 + i for i in range(n)])
    _assert_same_chunk(ens.make_ensemble_chunk(trainer, 5)(other), loop(other, 5))
    assert len(runner.capture_seconds) == captures


def test_graphed_chunk_raises_on_a_failed_launch(cuda_device, monkeypatch):  # noqa: F811
    """A graphed chunk whose launches fail raises with the CUDA error and
    runs no epoch: nothing falls back to the per-epoch loop."""
    import dataclasses

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("abgrall_l1"), {"model.layers": (2, 40, 40, 1),
                                              "sampling.n_f": 200, "train.chunk": 4})
    trainer = tr.Trainer(exp, device="cuda", dataset="twosin_burgers_shock")
    plan = k_fused.step_plan((2, 40, 40, 1), 200, trainer.problem.x_data.shape[0])
    monkeypatch.setattr(k_fused, "step_plan",
                        lambda *args: dataclasses.replace(plan, tile=64))
    before = (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS, k_fused.GRAPH_REPLAYS)
    with pytest.raises(RuntimeError, match="invalid argument"):
        trainer._get_chunk("adam")(trainer.init_state(), 4)
    assert (k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS, k_fused.GRAPH_REPLAYS) == before


def _f64_oracle(got, plain, exact):
    """The kernel is as accurate as the plain float32 version (x 4), against
    float64 (random deep nets cancel too much for a max-relative tolerance)."""
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= 4.0 * plain_err + 1e-6 * float(exact.abs().max()), (err, plain_err)


def _net(layers, seed, device):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(seed), device)
    for p in params:  # nonzero biases
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=torch.Generator().manual_seed(seed)))
    spec64 = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    params64 = [{k: v.double() for k, v in p.items()} for p in params]
    return spec, params, spec64, params64


@pytest.mark.parametrize("layers,n", [((2,) + (20,) * 8 + (1,), 1000),
                                      ((2, 256, 256, 3), 777),
                                      ((2, 64, 1), 3),
                                      (WIDE, 1), (WIDE, 100), (WIDE, 2_000), (WIDE, 8_191),
                                      (EULER, 200)])
def test_mlp_forward_kernels_match_plain_on_card(cuda_device, layers, n):  # noqa: F811
    """K5 forward against mlp_apply_reference, K5 backward against the
    plain backward, both judged against float64; two backward calls agree bit
    for bit. Every net but the 8x20 takes the wide design."""
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    spec, params, spec64, params64 = _net(layers, 4, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=14)).to(cuda_device)
    g = torch.from_numpy(np.random.default_rng(15).standard_normal((n, layers[-1]))
                         .astype(np.float32)).to(cuda_device)
    before = (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES)
    u = k_mlp.mlp_forward(spec, params, x)
    grad = k_mlp.mlp_backward(spec, params, x, g)
    again = k_mlp.mlp_backward(spec, params, x, g)
    torch.cuda.synchronize()
    assert (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert torch.equal(grad, again)
    _f64_oracle(u, mlp_apply_reference(spec, params, x),
                mlp_apply_reference(spec64, params64, x.double()))
    plain = k_mlp.mlp_backward_reference(spec, params, x, g)
    exact = k_mlp.mlp_backward_reference(spec64, params64, x.double(), g.double())
    off = 0
    for p, e in zip(plain, exact):
        _f64_oracle(grad[off:off + p.numel()].view(p.shape), p, e)
        off += p.numel()


@pytest.mark.parametrize("layers,n", [((2,) + (20,) * 8 + (1,), 1000),
                                      ((2, 256, 256, 3), 777),
                                      ((2, 64, 1), 3),
                                      (WIDE, 8_192), (WIDE, 8_191), (WIDE, 1)])
def test_taylor2_backward_kernel_matches_plain_on_card(cuda_device, layers, n):  # noqa: F811
    """K2 against the plain reverse mode, judged against float64, and the
    autograd Function (K1 + K2) against autograd through the plain
    recurrence; two calls agree bit for bit."""
    spec, params, spec64, params64 = _net(layers, 5, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=16)).to(cuda_device)
    rng = np.random.default_rng(17)
    cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32))
           .to(cuda_device) for _ in range(4)]
    before = k_taylor2.BACKWARD_LAUNCHES
    grad = k_taylor2.taylor2_backward(spec, params, x, cot)
    again = k_taylor2.taylor2_backward(spec, params, x, cot)
    torch.cuda.synchronize()
    assert k_taylor2.BACKWARD_LAUNCHES == before + 2 and torch.equal(grad, again)
    plain = k_taylor2.taylor2_backward_reference(spec, params, x, cot)
    exact = k_taylor2.taylor2_backward_reference(spec64, params64, x.double(),
                                                 [c.double() for c in cot])
    off = 0
    for p, e in zip(plain, exact):
        _f64_oracle(grad[off:off + p.numel()].view(p.shape), p, e)
        off += p.numel()
    leaves = [t.clone().requires_grad_(True) for p in params for t in (p["W"], p["b"])]
    net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
    outs = mlp_taylor_2(spec, net, x)
    via_fn = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)), leaves)
    for a, b in zip(via_fn, k_taylor2.split_grad(grad, leaves)):
        assert torch.equal(a, b)


def test_taylor2_backward_refuses_a_plan_that_does_not_fit(cuda_device, monkeypatch):  # noqa: F811
    """The kernel lays out its scratch itself: a plan with less scratch than
    that layout needs, or a split that is not whole row tiles, raises and
    counts no call."""
    import dataclasses

    spec, params, _, _ = _net(WIDE, 5, cuda_device)
    n = 1_000
    x = torch.from_numpy(numpy_points(n, seed=16)).to(cuda_device)
    cot = [torch.ones((n, 1), device=cuda_device) for _ in range(4)]
    plan = k_taylor2.backward_plan(spec.layers, n)
    before = k_taylor2.BACKWARD_LAUNCHES
    for bad in (dataclasses.replace(plan, gbuf=plan.gbuf - 4),
                dataclasses.replace(plan, split_rows=plan.split_rows + 4)):
        monkeypatch.setattr(k_taylor2, "backward_plan", lambda *args, bad=bad: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k_taylor2.taylor2_backward(spec, params, x, cot)
    assert k_taylor2.BACKWARD_LAUNCHES == before


def test_mlp_backward_refuses_a_plan_that_does_not_fit(cuda_device, monkeypatch):  # noqa: F811
    """The wide K5 lays out its scratch itself: a plan with less scratch than
    that layout needs, a split that is not whole row tiles, or a tile it does
    not instantiate raises and counts no call."""
    import dataclasses

    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    spec, params, _, _ = _net(WIDE, 6, cuda_device)
    n = 1_000
    x = torch.from_numpy(numpy_points(n, seed=18)).to(cuda_device)
    g = torch.ones((n, 1), device=cuda_device)
    plan = k_mlp.mlp_backward_plan(spec.layers, n)
    before = k_mlp.BACKWARD_LAUNCHES
    for bad in (dataclasses.replace(plan, partials=plan.partials - 4),
                dataclasses.replace(plan, split_rows=plan.split_rows + 4),
                dataclasses.replace(plan, tile=64)):
        monkeypatch.setattr(k_mlp, "mlp_backward_plan", lambda *args, bad=bad: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            k_mlp.mlp_backward(spec, params, x, g)
    assert k_mlp.BACKWARD_LAUNCHES == before


def test_hybrid_trainer_on_card(cuda_device):  # noqa: F811
    """abgrall_admm through the switch on the card: Adam epochs on K3, then
    L-BFGS outer epochs as K10's chunk runner (K3's value-and-grad, then
    K3's post-update mode and the reset in place, one post-update an outer
    epoch; no launch of K5, forward or backward, and no backward of K2);
    K1 runs for the initial ADMM state and the final evaluation; nothing
    raises."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {
        "train.epochs": 22, "train.chunk": 10, "train.log_every": 0,
        "optimizer.switch_epoch": 20, "optimizer.lbfgs.max_iters": 20})
    k3, k5, k2 = k_fused.GRAPH_EPOCHS, k_mlp.BACKWARD_LAUNCHES, k_taylor2.BACKWARD_LAUNCHES
    k3_calls, solves = k_fused.LAUNCHES, k_lbfgs.SOLVES
    k5_fwd, k1 = k_mlp.LAUNCHES, k_taylor2.LAUNCHES
    chunk_epochs, posts = k_lbfgs.CHUNK_EPOCHS, k_fused.POST_UPDATE_LAUNCHES
    state, summary = Trainer(exp, device="cuda").train()
    assert k_fused.GRAPH_EPOCHS == k3 + 20 and k_fused.LAUNCHES == k3_calls
    assert state.epoch == 22
    assert k_lbfgs.SOLVES == solves + 2
    assert k_lbfgs.CHUNK_EPOCHS == chunk_epochs + 2 and k_fused.POST_UPDATE_LAUNCHES == posts + 2
    assert k_mlp.BACKWARD_LAUNCHES == k5 and k_taylor2.BACKWARD_LAUNCHES == k2
    assert k_mlp.LAUNCHES == k5_fwd and k_taylor2.LAUNCHES > k1
    assert np.isfinite(summary["rel_l2_u"])


# -- K6: the bf16 stream policy -------------------------------------------------

K6_POLICIES = [(keep, me) for keep in ((), ("xx",), ("value",), ("value", "xx"))
               for me in (False, True)]


def _mixed(layers, keep, me):
    return MLPSpec(layers=layers, lb=LB, ub=UB, compute_dtype="bfloat16", keep_streams=keep,
                   mixed_elementwise=me)


def _envelope(got, plain, exact, factor=2.0):
    """The TPU test's envelope: the kernel's error against float64 at most
    ``factor`` x the plain mixed version's + 1e-6 max|float64|."""
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= factor * plain_err + 1e-6 * float(exact.abs().max()), (err, plain_err)


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _near_plain(got, plain, unrounded):
    """K6 against the plain mixed version on the same inputs: at least ten
    times nearer it (in relative L2) than the plain version is to the float32
    pass without the policy, + 1e-5 for the order of float32 sums. A kernel
    that skipped or misplaced a rounding sits about as far from the plain
    version as the float32 pass does; one bf16 rounding that flips the other
    way at a rare point moves the relative L2 far less."""
    assert _rel_l2(got, plain) <= 0.1 * _rel_l2(unrounded, plain) + 1e-5, (
        _rel_l2(got, plain), _rel_l2(unrounded, plain))


K6_SHAPES = [((2, 64, 64, 64, 1), 1000), (WIDE, 8_192), (WIDE, 8_191), (WIDE, 1)]


def _close_plain(got, plain, tol):
    """max|got - plain| <= tol max|plain| (chip_smoke.py's K6_PLAIN_TOL test)."""
    assert float((got - plain).abs().max()) <= tol * float(plain.abs().max())


@pytest.mark.parametrize("layers,n", K6_SHAPES, ids=[f"{max(l)}w-n{n}" for l, n in K6_SHAPES])
@pytest.mark.parametrize("keep,me", K6_POLICIES,
                         ids=[f"keep-{'-'.join(k) or 'none'}{'-me' if m else ''}"
                              for k, m in K6_POLICIES])
def test_k6_matches_plain_on_card(cuda_device, keep, me, layers, n):  # noqa: F811
    """K6 forward against the plain mixed recurrence and K6's backward against
    the plain reverse mode under the policy (taylor2_backward_reference), on
    the same inputs, for every flag combination; two backward calls agree bit
    for bit.

    At the small net: both within the TPU test's envelope against float64,
    near the plain version (_near_plain), and the backward near autograd
    through the plain recurrence. At 8x200 (one burgers_scale microbatch, a
    ragged N): the smoke's phase-16 test, within 3e-5 max|plain| of the plain
    version per stream and leaf, and within the envelope against float64
    beside the plain version. Autograd rounds the cotangents to bf16, which
    at this depth moves a bias leaf that cancels by more than 0.2 of itself.
    At one point no average hides a bf16 rounding that a float32 sum in
    another order flips (2^-8 of a value): there within 1e-2 max|plain|."""
    small = layers != WIDE
    spec32, params, spec64, params64 = _net(layers, 6, cuda_device)
    spec = _mixed(layers, keep, me)
    x = torch.from_numpy(numpy_points(n, seed=18)).to(cuda_device)
    before = k_taylor2.MIXED_LAUNCHES
    got = k_taylor2.taylor2(spec, params, x)
    assert k_taylor2.MIXED_LAUNCHES == before + 1
    plain = mlp_taylor_2_reference(spec, params, x)
    unrounded = mlp_taylor_2_reference(spec32, params, x)
    exact = mlp_taylor_2_reference(spec64, params64, x.double())
    rng = np.random.default_rng(19)
    cot = [torch.from_numpy((rng.standard_normal((n, 1)) / n).astype(np.float32))
           .to(cuda_device) for _ in range(4)]
    before = k_taylor2.MIXED_BACKWARD_LAUNCHES
    grad = k_taylor2.taylor2_backward(spec, params, x, cot)
    again = k_taylor2.taylor2_backward(spec, params, x, cot)
    torch.cuda.synchronize()
    assert k_taylor2.MIXED_BACKWARD_LAUNCHES == before + 2 and torch.equal(grad, again)
    leaves = [t.clone().requires_grad_(True) for p in params for t in (p["W"], p["b"])]
    plain_g = k_taylor2.taylor2_backward_reference(spec, params, x, cot)
    unrounded_g = k_taylor2.taylor2_backward_reference(spec32, params, x, cot)
    exact_g = k_taylor2.taylor2_backward_reference(spec64, params64, x.double(),
                                                   [c.double() for c in cot])
    pairs = list(zip(got, plain, unrounded, exact)) + list(
        zip(k_taylor2.split_grad(grad, leaves), plain_g, unrounded_g, exact_g))
    if small:
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        outs = mlp_taylor_2_reference(spec, net, x)
        auto = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)), leaves)
        for i, (g, p, u, e) in enumerate(pairs):
            _near_plain(g, p, u)
            if i < len(got):
                _envelope(g, p, e)
            else:
                a = auto[i - len(got)]
                _envelope(g, a, e)
                assert float((g - a).abs().max()) <= 0.2 * float(a.abs().max())
    else:
        for g, p, u, e in pairs:
            _close_plain(g, p, 3e-5 if n > 1 else 1e-2)
            if n > 1:
                _envelope(g, p, e)


# The forward alone at ragged and edge shapes: the tiled design at 8x200 and
# at a width that is no multiple of its 8-unit column groups or 16-byte rows
# (8x50), the narrow design at 8x20 (launch_config's choice is checked).
FWD_SHAPES = [(WIDE, 1), (WIDE, 31), (WIDE, 8_191), (WIDE, 65_537),
              ((2,) + (50,) * 8 + (1,), 31), ((2,) + (50,) * 8 + (1,), 8_191),
              ((2,) + (20,) * 8 + (1,), 1), ((2,) + (20,) * 8 + (1,), 31),
              ((2,) + (20,) * 8 + (1,), 8_191)]
FWD_POLICIES = {"f32": None, "keep-none": ((), False), "keep-xx": (("xx",), False),
                "max": ((), True)}


@pytest.mark.parametrize("layers,n", FWD_SHAPES,
                         ids=[f"{len(l) - 2}x{max(l)}-n{n}" for l, n in FWD_SHAPES])
@pytest.mark.parametrize("policy", list(FWD_POLICIES))
def test_forward_design_on_card(cuda_device, policy, layers, n):  # noqa: F811
    """K1 (f32) and K6 (the burgers_scale policies) in one launch each, at
    ragged N, held over at least 8,191 points: K1 against float64 within 4x
    the plain version's error; K6 within the TPU test's envelope (2x) and 3e-5
    max|plain| of the plain mixed version per stream. A point's sums do not
    depend on the other points or on its place in the grid, so a call of
    fewer points equals, bit for bit, the same points inside an 8,191-point
    call: a few points average out no bf16 rounding that a float32 sum in
    another order flips (2^-8 of a value), and bit-equality leaves no room."""
    spec32, params, spec64, params64 = _net(layers, 9, cuda_device)
    spec = spec32 if FWD_POLICIES[policy] is None else _mixed(layers, *FWD_POLICIES[policy])
    cfg = k_taylor2.launch_config(layers, spec.mixed)
    assert cfg.design == ("narrow" if max(layers) <= k_taylor2.NARROW_WIDTH else "tiled")
    held = max(n, 8_191)
    x = torch.from_numpy(numpy_points(held, seed=22)).to(cuda_device)
    before = (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES)
    got = k_taylor2.taylor2(spec, params, x[:n])
    torch.cuda.synchronize()
    assert (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES) == (
        before[0] + (0 if spec.mixed else 1), before[1] + (1 if spec.mixed else 0))
    full = k_taylor2.taylor2(spec, params, x) if held > n else got
    plain = mlp_taylor_2_reference(spec, params, x)
    exact = mlp_taylor_2_reference(spec64, params64, x.double())
    for g, f, p, e in zip(got, full, plain, exact):
        assert g.shape == (n, 1) and torch.equal(g, f[:n])
        assert bool(torch.isfinite(f).all())
        _envelope(f, p, e, 2.0 if spec.mixed else 4.0)
        if spec.mixed:
            _close_plain(f, p, 3e-5)


def test_mixed_spec_on_card_reaches_k6_only(cuda_device):  # noqa: F811
    """mlp_taylor_2 with a mixed spec on a CUDA tensor launches K6 forward and
    backward, never K1 or K2."""
    layers = (2, 32, 32, 1)
    spec = _mixed(layers, ("xx",), False)
    _, params, _, _ = _net(layers, 7, cuda_device)
    leaves = [t.clone().requires_grad_(True) for p in params for t in (p["W"], p["b"])]
    net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
    x = torch.from_numpy(numpy_points(100, seed=20)).to(cuda_device)
    k1 = (k_taylor2.LAUNCHES, k_taylor2.BACKWARD_LAUNCHES)
    k6 = (k_taylor2.MIXED_LAUNCHES, k_taylor2.MIXED_BACKWARD_LAUNCHES)
    outs = mlp_taylor_2(spec, net, x)
    torch.autograd.grad(sum(o.sum() for o in outs), leaves)
    torch.cuda.synchronize()
    assert (k_taylor2.LAUNCHES, k_taylor2.BACKWARD_LAUNCHES) == k1
    k6_after = (k_taylor2.MIXED_LAUNCHES, k_taylor2.MIXED_BACKWARD_LAUNCHES)
    assert k6_after == (k6[0] + 1, k6[1] + 1)


@pytest.mark.parametrize("spec_kw,match", [
    ({"compute_dtype": "bfloat16", "dtype": torch.float64}, "float32 masters|float32 points"),
    ({"compute_dtype": "float16"}, "computes in bfloat16"),
], ids=["f64-masters", "float16"])
def test_k6_raises_on_card_instead_of_falling_back(cuda_device, spec_kw, match):  # noqa: F811
    spec = MLPSpec(layers=(2, 16, 1), lb=LB, ub=UB, **spec_kw)
    params = init_mlp(spec, torch.Generator().manual_seed(8), cuda_device)
    x = torch.from_numpy(numpy_points(10, seed=21)).to(cuda_device).to(spec.dtype)
    before = (k_taylor2.MIXED_LAUNCHES, k_taylor2.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        mlp_taylor_2(spec, params, x)
    assert (k_taylor2.MIXED_LAUNCHES, k_taylor2.LAUNCHES) == before


def test_mixed_microbatched_trainer_on_card(cuda_device):  # noqa: F811
    """burgers_scale cut to a small net and batch, max policy in 4
    microbatches: every epoch launches K6 forward and backward once per
    microbatch, K1, K2 and K3 never."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("burgers_scale"), {
        "model.layers": (2, 32, 32, 1), "sampling.n_f": 1024, "sampling.microbatch": 4,
        "model.compute_dtype": "bfloat16", "model.mixed_elementwise": True,
        "train.epochs": 5, "train.chunk": 5, "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    state = trainer.init_state()
    before = (k_taylor2.MIXED_LAUNCHES, k_taylor2.MIXED_BACKWARD_LAUNCHES, k_taylor2.LAUNCHES,
              k_taylor2.BACKWARD_LAUNCHES, k_fused.LAUNCHES)
    state, _ = trainer.train(state)
    after = (k_taylor2.MIXED_LAUNCHES, k_taylor2.MIXED_BACKWARD_LAUNCHES, k_taylor2.LAUNCHES,
             k_taylor2.BACKWARD_LAUNCHES, k_fused.LAUNCHES)
    # the final evaluation adds K6 forward launches over the grid
    assert after[0] - before[0] >= 20 and after[1] - before[1] == 20
    assert after[2:] == before[2:]
    assert state.epoch == 5


# -- K7a: the Taylor-1 streams (the Euler slice) ------------------------------

K7A_SHAPES = [((2, 20, 20, 20, 3), 1_000), ((2, 20, 20, 20, 3), 1), (EULER, 1_000),
              (EULER, 8_192), (EULER, 8_191), (EULER, 1), ((2, 256, 3), 777)]


@pytest.mark.parametrize("layers,n", K7A_SHAPES,
                         ids=[f"{len(l) - 2}x{max(l)}-n{n}" for l, n in K7A_SHAPES])
def test_k7a_matches_plain_on_card(cuda_device, layers, n):  # noqa: F811
    """K7a's forward and backward against the plain versions, judged against
    float64 (the wide nets) or within rtol 1e-5 of plain float32 (the narrow
    net); the autograd Function's gradient equals the backward kernel's; two
    backward calls agree bit for bit."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_1_reference

    spec, params, spec64, params64 = _net(layers, 9, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=18)).to(cuda_device)
    rng = np.random.default_rng(19)
    cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32))
           .to(cuda_device) for _ in range(3)]
    f0, b0 = k_taylor1.LAUNCHES, k_taylor1.BACKWARD_LAUNCHES
    outs = k_taylor1.taylor1(spec, params, x)
    grad = k_taylor1.taylor1_backward(spec, params, x, cot)
    again = k_taylor1.taylor1_backward(spec, params, x, cot)
    torch.cuda.synchronize()
    assert (k_taylor1.LAUNCHES, k_taylor1.BACKWARD_LAUNCHES) == (f0 + 1, b0 + 2)
    assert torch.equal(grad, again)
    plain = mlp_taylor_1_reference(spec, params, x)
    exact = mlp_taylor_1_reference(spec64, params64, x.double())
    wide = max(layers) > 32
    for g, p, e in zip(outs, plain, exact):
        assert g.shape == (n, layers[-1])
        _close_or_f64(g, p, e, wide)
    pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
    egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                 [c.double() for c in cot])
    off = 0
    for p, e in zip(pgrad, egrad):
        _close_or_f64(grad[off:off + p.numel()].view(p.shape), p, e, wide)
        off += p.numel()
    leaves = [t.clone().requires_grad_(True) for p in params for t in (p["W"], p["b"])]
    net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
    via = mlp_taylor_1(spec, net, x)
    via_fn = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(via, cot)), leaves)
    for a, b in zip(via_fn, k_taylor1.split_grad(grad, leaves)):
        assert torch.equal(a, b)


def test_k7a_refuses_on_card_instead_of_falling_back(cuda_device):  # noqa: F811
    """A mixed spec and a plan whose scratch is too small raise on the card."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1

    layers = (2, 20, 20, 3)
    mixed = MLPSpec(layers=layers, lb=LB, ub=UB, compute_dtype="bfloat16")
    params = init_mlp(mixed, torch.Generator().manual_seed(2), cuda_device)
    x = torch.from_numpy(numpy_points(16, seed=3)).to(cuda_device)
    with pytest.raises(ValueError, match="later slice"):
        mlp_taylor_1(mixed, params, x)
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    cot = [torch.zeros((16, 3), device=cuda_device) for _ in range(3)]
    real = k_taylor1.taylor1_plan

    def shrink(*a, **k):
        # the stacked inputs (wide), the kept outputs (narrow backward) and the
        # narrow forward's threads cut below what the kernels take
        return __import__("dataclasses").replace(real(*a, **k), hbuf=4, threads=2048)

    try:
        k_taylor1.taylor1_plan = shrink
        for design in ("wide", "narrow"):
            with pytest.raises(RuntimeError, match="invalid argument"):
                k_taylor1.taylor1(spec, params, x, design=design)
            with pytest.raises(RuntimeError, match="invalid argument"):
                k_taylor1.taylor1_backward(spec, params, x, cot, design=design)
    finally:
        k_taylor1.taylor1_plan = real
    with pytest.raises(ValueError, match="narrow design"):
        k_taylor1.taylor1(MLPSpec(layers=(2, 64, 3), lb=LB, ub=UB),
                          init_mlp(MLPSpec(layers=(2, 64, 3), lb=LB, ub=UB),
                                   torch.Generator().manual_seed(2), cuda_device), x,
                          design="narrow")


K7A_DESIGN_NS = (1, 31, 1_000, 16_000, 25_600)


@pytest.mark.parametrize("layers", [(2,) + (20,) * 8 + (1,), (2, 20, 20, 20, 3)],
                         ids=["8x20", "3x20"])
def test_k7a_narrow_forward_equals_wide_on_card(cuda_device, layers):  # noqa: F811
    """K7a's narrow design (one launch) and its wide design give the same
    streams bit for bit at N 1, 31, 1,000, 16,000 and 25,600: each output is
    the same float32 chain in both."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1

    spec, params, _, _ = _net(layers, 24, cuda_device)
    for n in K7A_DESIGN_NS:
        x = torch.from_numpy(numpy_points(n, seed=25 + n)).to(cuda_device)
        n0 = k_taylor1.NARROW_LAUNCHES
        narrow = k_taylor1.taylor1(spec, params, x)
        wide = k_taylor1.taylor1(spec, params, x, design="wide")
        torch.cuda.synchronize()
        assert k_taylor1.NARROW_LAUNCHES == n0 + 1
        for a, b in zip(narrow, wide):
            assert a.shape == (n, layers[-1]) and torch.equal(a, b), n


@pytest.mark.parametrize("design", ["narrow", "wide"])
@pytest.mark.parametrize("n", [1, 1_000, 16_000])
def test_k7a_backward_designs_on_card(cuda_device, design, n):  # noqa: F811
    """Both designs' backwards at 8x20: two calls agree bit for bit, and each
    leaf within rtol 1e-4 / atol 1e-5 max|plain| of the plain reverse mode or,
    where a sum cancels, within 4x its error from float64."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1

    layers = (2,) + (20,) * 8 + (1,)
    spec, params, spec64, params64 = _net(layers, 26, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=27)).to(cuda_device)
    rng = np.random.default_rng(28)
    cot = [torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(cuda_device)
           for _ in range(3)]
    b0 = k_taylor1.NARROW_BACKWARD_LAUNCHES
    grad = k_taylor1.taylor1_backward(spec, params, x, cot, design=design)
    again = k_taylor1.taylor1_backward(spec, params, x, cot, design=design)
    torch.cuda.synchronize()
    assert k_taylor1.NARROW_BACKWARD_LAUNCHES == b0 + (2 if design == "narrow" else 0)
    assert torch.equal(grad, again)
    pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
    egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                 [c.double() for c in cot])
    off = 0
    for p, e in zip(pgrad, egrad):
        _close_or_f64(grad[off:off + p.numel()].view(p.shape), p, e, wide=True)
        off += p.numel()


def test_euler_trainer_on_card(cuda_device):  # noqa: F811
    """euler_admm_tuned on the card for a few epochs: every residual through
    K7a (forward and backward), the data term through K5."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("euler_admm_tuned"), {"train.epochs": 6, "train.chunk": 3,
                                                     "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    f0, b0 = k_taylor1.LAUNCHES, k_taylor1.BACKWARD_LAUNCHES
    k5 = k_mlp.BACKWARD_LAUNCHES
    state, summary = trainer.train()
    # init + per epoch one loss forward and one tail forward, + the evaluation
    assert k_taylor1.LAUNCHES - f0 == 1 + 2 * 6 + 1
    assert k_taylor1.BACKWARD_LAUNCHES - b0 == 6 and k_mlp.BACKWARD_LAUNCHES - k5 == 6
    assert all(np.isfinite(summary[f"rel_l2_{f}"]) for f in ("rho", "u", "E"))


# -- shock paths in K7a's and K5's input passes (slice 2b-ii) --------------------

PATH_SHAPES = [("k7a", EULER, 1_000), ("k7a", EULER, 8_191), ("k7a", EULER, 1),
               ("k7a", (2, 20, 20, 3), 777), ("k5", EULER, 200), ("k5", EULER, 8_191),
               ("k5", EULER, 1)]


def _path_net(layers, seed, device):
    """A path net (K 2, degree 2) with its paths moved off their init:
    curved fronts and unequal sharpness, nonzero biases."""
    kw = dict(layers=layers, lb=LB, ub=UB, n_paths=2, path_degree=2, path_sharpness=12.0)
    spec, spec64 = MLPSpec(**kw), MLPSpec(dtype=torch.float64, **kw)
    params = init_mlp(spec, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params:
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
    params[0]["path_c"].add_(0.3 * torch.randn((2, 3), generator=gen).to(device))
    params[0]["path_a"].mul_(1.0 + 0.2 * torch.randn(2, generator=gen).to(device))
    params64 = [{k: v.double() for k, v in p.items()} for p in params]
    return spec, params, spec64, params64


@pytest.mark.parametrize("kernel,layers,n", PATH_SHAPES,
                         ids=[f"{k}-{len(l) - 2}x{max(l)}-n{n}" for k, l, n in PATH_SHAPES])
def test_path_kernels_match_plain_on_card(cuda_device, kernel, layers, n):  # noqa: F811
    """K7a and K5 (wide) with two shock paths: the forward and every gradient
    leaf, path_c and path_a included, by the float64 criterion (the narrow
    K7a net within rtol 1e-5 of plain float32 first); the autograd
    Function's gradient equals the backward kernel's; two backward calls
    agree bit for bit."""
    from pinns_tpu_torch.models.mlp import mlp_apply, mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_1_reference

    spec, params, spec64, params64 = _path_net(layers, 21, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=22)).to(cuda_device)
    rng = np.random.default_rng(23)
    streams = 3 if kernel == "k7a" else 1
    cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32))
           .to(cuda_device) for _ in range(streams)]
    if kernel == "k7a":
        outs = k_taylor1.taylor1(spec, params, x)
        grad = k_taylor1.taylor1_backward(spec, params, x, cot)
        again = k_taylor1.taylor1_backward(spec, params, x, cot)
        plain = mlp_taylor_1_reference(spec, params, x)
        exact = mlp_taylor_1_reference(spec64, params64, x.double())
        pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
        egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                     [c.double() for c in cot])
        fn = mlp_taylor_1
    else:
        outs = (k_mlp.mlp_forward(spec, params, x),)
        grad = k_mlp.mlp_backward(spec, params, x, cot[0])
        again = k_mlp.mlp_backward(spec, params, x, cot[0])
        plain = (mlp_apply_reference(spec, params, x),)
        exact = (mlp_apply_reference(spec64, params64, x.double()),)
        pgrad = k_mlp.mlp_backward_reference(spec, params, x, cot[0])
        egrad = k_mlp.mlp_backward_reference(spec64, params64, x.double(), cot[0].double())
        fn = lambda s, p, xx: (mlp_apply(s, p, xx),)  # noqa: E731
    torch.cuda.synchronize()
    assert torch.equal(grad, again)
    assert grad.numel() == spec.n_params == sum(p.numel() for p in pgrad)
    wide = max(layers) > 32
    for g, p, e in zip(outs, plain, exact):
        _close_or_f64(g, p, e, wide)
    off = 0
    for p, e in zip(pgrad, egrad):
        _close_or_f64(grad[off:off + p.numel()].view(p.shape), p, e, wide)
        off += p.numel()
    leaves = [t.clone().requires_grad_(True) for t in k_taylor2.net_leaves(params)]
    via = fn(spec, k_taylor2.net_from_leaves(leaves, spec.n_paths), x)
    via_fn = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(via, cot)), leaves)
    for a, b in zip(via_fn, k_taylor2.split_grad(grad, leaves)):
        assert torch.equal(a, b)


def test_kernels_without_paths_refuse_them_on_card(cuda_device):  # noqa: F811
    """K6 (the mixed policy) raises on a path or Fourier spec, naming the
    ROADMAP item; K1/K2 and K5 take a narrow path net (K5 on its wide
    design), and neither falls back to the plain version."""
    import dataclasses

    from pinns_tpu_torch.models.mlp import fourier_matrix
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2

    spec, params, _, _ = _path_net((2, 20, 20, 1), 24, cuda_device)
    x = torch.from_numpy(numpy_points(16, seed=25)).to(cuda_device)
    before = (k_taylor2.LAUNCHES, k_mlp.LAUNCHES)
    mlp_taylor_2(spec, params, x)
    k_mlp.mlp_forward(spec, params, x)
    assert (k_taylor2.LAUNCHES, k_mlp.LAUNCHES) == (before[0] + 1, before[1] + 1)
    for kw in ({}, {"n_paths": 0, "fourier": fourier_matrix(4)}):
        mixed = dataclasses.replace(spec, compute_dtype=torch.bfloat16, **kw)
        net = init_mlp(mixed, torch.Generator().manual_seed(1), cuda_device)
        with pytest.raises(ValueError, match="ROADMAP queue 2, K6"):
            mlp_taylor_2(mixed, net, x)


# (kernel, widths, N, Fourier features F, paths K): K1's tiled design and K2
# at 8x20 (input width 2 + 2F + K) and wider, K7a's and K5's wide designs at
# the Euler trunk and at narrow widths (a feature net takes the wide design)
FEATURE_SHAPES = [("k1", NARROW, 1_000, 16, 0), ("k1", NARROW, 1_000, 0, 2),
                  ("k1", NARROW, 777, 16, 2), ("k1", WIDE, 300, 16, 0),
                  ("k2", NARROW, 1_000, 16, 0), ("k2", NARROW, 1_000, 0, 2),
                  ("k2", NARROW, 333, 16, 2), ("k2", (2, 64, 64, 1), 200, 4, 2),
                  ("k7a", EULER, 1_000, 16, 0), ("k7a", EULER, 1_000, 16, 2),
                  ("k7a", (2, 20, 20, 3), 77, 4, 0),
                  ("k5", EULER, 1_000, 16, 0), ("k5", EULER, 300, 16, 2),
                  ("k5", NARROW, 100, 4, 0)]


def _feature_net(layers, n_fourier, n_paths, seed, device):
    """A net with F Fourier features (sigma 3, PARITY's setting; one B for
    every seed) and K paths moved off their init, nonzero biases; and its
    float64 twin."""
    from pinns_tpu_torch.models.mlp import fourier_matrix

    kw = dict(layers=layers, lb=LB, ub=UB, n_paths=n_paths, path_degree=2,
              path_sharpness=12.0,
              fourier=fourier_matrix(n_fourier, sigma=3.0) if n_fourier else ())
    spec, spec64 = MLPSpec(**kw), MLPSpec(dtype=torch.float64, **kw)
    params = init_mlp(spec, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params:
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
    if n_paths:
        params[0]["path_c"].add_(0.3 * torch.randn(params[0]["path_c"].shape, generator=gen)
                                 .to(device))
        params[0]["path_a"].mul_(1.0 + 0.2 * torch.randn(n_paths, generator=gen).to(device))
    params64 = [{k: v.double() for k, v in p.items()} for p in params]
    return spec, params, spec64, params64


@pytest.mark.parametrize("kernel,layers,n,f,k", FEATURE_SHAPES,
                         ids=[f"{kn}-{len(l) - 2}x{max(l[1:])}-n{n}-F{f}-K{k}"
                              for kn, l, n, f, k in FEATURE_SHAPES])
def test_fourier_kernels_match_plain_on_card(cuda_device, kernel, layers, n, f, k):  # noqa: F811
    """K1 (tiled) and K2, K7a (wide) and K5 (wide) with Fourier features and
    shock paths: every stream and gradient leaf (path_c and path_a included)
    within 4x the plain float32 version's error from float64; the autograd
    Function's gradient equals the backward kernel's; two backward calls agree
    bit for bit; the narrow designs are not used."""
    from pinns_tpu_torch.models.mlp import mlp_apply, mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_1_reference

    spec, params, spec64, params64 = _feature_net(layers, f, k, 31, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=32)).to(cuda_device)
    x64 = x.double()
    rng = np.random.default_rng(33)
    streams = {"k1": 4, "k2": 4, "k7a": 3, "k5": 1}[kernel]
    cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32))
           .to(cuda_device) for _ in range(streams)]
    if kernel in ("k1", "k2"):
        assert k_taylor2.launch_config(spec.widths).design == "tiled"
        outs = k_taylor2.taylor2(spec, params, x)
        grad = k_taylor2.taylor2_backward(spec, params, x, cot)
        again = k_taylor2.taylor2_backward(spec, params, x, cot)
        plain = mlp_taylor_2_reference(spec, params, x)
        exact = mlp_taylor_2_reference(spec64, params64, x64)
        pgrad = k_taylor2.taylor2_backward_reference(spec, params, x, cot)
        egrad = k_taylor2.taylor2_backward_reference(spec64, params64, x64,
                                                     [c.double() for c in cot])
        fn = mlp_taylor_2
    elif kernel == "k7a":
        assert k_taylor1.default_design(spec.widths) == "wide"
        outs = k_taylor1.taylor1(spec, params, x)
        grad = k_taylor1.taylor1_backward(spec, params, x, cot)
        again = k_taylor1.taylor1_backward(spec, params, x, cot)
        plain = mlp_taylor_1_reference(spec, params, x)
        exact = mlp_taylor_1_reference(spec64, params64, x64)
        pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
        egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x64,
                                                     [c.double() for c in cot])
        fn = mlp_taylor_1
    else:
        assert k_mlp.design(spec.widths) == "wide"
        outs = (k_mlp.mlp_forward(spec, params, x),)
        grad = k_mlp.mlp_backward(spec, params, x, cot[0])
        again = k_mlp.mlp_backward(spec, params, x, cot[0])
        plain = (mlp_apply_reference(spec, params, x),)
        exact = (mlp_apply_reference(spec64, params64, x64),)
        pgrad = k_mlp.mlp_backward_reference(spec, params, x, cot[0])
        egrad = k_mlp.mlp_backward_reference(spec64, params64, x64, cot[0].double())
        fn = lambda s, p, xx: (mlp_apply(s, p, xx),)  # noqa: E731
    torch.cuda.synchronize()
    assert torch.equal(grad, again)
    assert grad.numel() == spec.n_params == sum(p.numel() for p in pgrad)
    for g, p, e in zip(outs, plain, exact):
        _f64_oracle(g.cpu(), p.cpu(), e.cpu())
    off = 0
    for p, e in zip(pgrad, egrad):
        _f64_oracle(grad[off:off + p.numel()].view(p.shape).cpu(), p.cpu(), e.cpu())
        off += p.numel()
    leaves = [t.clone().requires_grad_(True) for t in k_taylor2.net_leaves(params)]
    via = fn(spec, k_taylor2.net_from_leaves(leaves, spec.n_paths), x)
    via_fn = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(via, cot)), leaves)
    for a, b in zip(via_fn, k_taylor2.split_grad(grad, leaves)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("f,k", [(16, 0), (4, 2)])
def test_fourier_k8s_members_equal_solo_k1_on_card(cuda_device, f, k):  # noqa: F811
    """K8s (a) with Fourier and path features: each member's streams equal a
    solo K1 call on its net bit for bit."""
    from pinns_tpu_torch.parallel.ensemble import pack_members

    nets, spec = [], None
    for m in range(3):  # the members share one B
        spec, net, _, _ = _feature_net(NARROW, f, k, 40 + m, cuda_device)
        nets.append(net)
    flat = pack_members(nets)
    x = torch.from_numpy(numpy_points(555, seed=41)).to(cuda_device)
    got = k_taylor2.taylor2_members(spec, flat, x)
    for m, net in enumerate(nets):
        solo = k_taylor2.taylor2(spec, net, x)
        for g, s in zip(got, solo):
            assert torch.equal(g[m], s)



def test_euler_weak_fast_trainer_on_card(cuda_device):  # noqa: F811
    """euler_weak_fast on the card for a few epochs: the edge points through
    K7a with paths (viscous), the strong mass residual at the centres through
    K7a again, the data term through K5, the cell means through K7b."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import weakform as k_weak
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("euler_weak_fast"), {"train.epochs": 6, "train.chunk": 3,
                                                    "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    before = (k_taylor1.LAUNCHES, k_taylor1.BACKWARD_LAUNCHES, k_mlp.LAUNCHES,
              k_mlp.BACKWARD_LAUNCHES, k_weak.LAUNCHES)
    state, summary = trainer.train()
    after = (k_taylor1.LAUNCHES, k_taylor1.BACKWARD_LAUNCHES, k_mlp.LAUNCHES,
             k_mlp.BACKWARD_LAUNCHES, k_weak.LAUNCHES)
    # an epoch: K7a at the edge points and at the centres, forward and
    # backward; K5 on the data term; K7b once; + the evaluation's K7a
    assert [a - b for a, b in zip(after, before)] == [2 * 6 + 1, 2 * 6, 6, 6, 6]
    assert state.epoch == 6 and state.params["net"][0]["path_c"].shape == (2, 3)
    assert all(np.isfinite(summary[f"rel_l2_{f}"]) for f in ("rho", "u", "E"))


# -- K7b: the weak-form flux quadrature (slice 2b-i) ---------------------------

K7B_CASES = [("burgers", True, 1_000), ("burgers", False, 1_000), ("euler", True, 1_000),
             ("euler", False, 1_000), ("burgers", True, 65_536), ("euler", True, 65_536),
             ("euler", False, 1)]


def _k7b_inputs(kind, viscous, n, device):
    """Centers (bounds and clipped cells included) and the edge values of a
    smooth field: (centers, y, yx or None, coefficient vector)."""
    rng = np.random.default_rng(n + 3)
    c = rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)
    c[: min(n, 4)] = [(LB[0], LB[1]), (UB[0], UB[1]), (LB[0], UB[1]), (UB[0], LB[1])][: min(n, 4)]
    fields = 1 if kind == "burgers" else 3
    m = n * 16
    base = np.zeros(fields) if kind == "burgers" else np.array([1.0, 0.3, 2.5])
    y = (base + 0.3 * rng.standard_normal((m, fields))).astype(np.float32)
    yx = rng.standard_normal((m, fields)).astype(np.float32) if viscous else None
    coeffs = [0.377, 1e-3] if kind == "burgers" else [0.4, float(np.exp(-6.0))]
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return t(c), t(y), t(yx), torch.tensor(coeffs, dtype=torch.float32, device=device)


def _k7b_plain(kind, y, yx, hxe, hte, coeffs):
    from pinns_tpu_torch.ops import weakform as twf

    if kind == "burgers":
        return twf.burgers_quadrature_reference(y, yx, hxe, hte, coeffs[0], coeffs[1], 4)[0]
    return torch.cat(twf.euler_quadrature_reference(y, yx, hxe, hte, float(coeffs[0].detach()) + 1.0,
                                                    coeffs[1], 4)[0], dim=1)


@pytest.mark.parametrize("kind,viscous,n", K7B_CASES,
                         ids=[f"{k}-{'visc' if v else 'invisc'}-n{n}" for k, v, n in K7B_CASES])
def test_k7b_matches_plain_on_card(cuda_device, kind, viscous, n):  # noqa: F811
    """K7b's edge points equal the plain version's bit for bit; r and the
    backward (g_y, g_yx, the coefficients' gradient) lie within the float64
    criterion of the plain version (autograd through it for the backward);
    two backward calls agree bit for bit; each call counts one launch."""
    from pinns_tpu_torch.ops import weakform as twf
    from pinns_tpu_torch.ops.kernels import weakform as k7b

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    c, y, yx, coeffs = _k7b_inputs(kind, viscous, n, cuda_device)
    hx, ht = 0.02 * (UB[0] - LB[0]), 0.02 * (UB[1] - LB[1])
    counts = (k7b.EDGE_LAUNCHES, k7b.LAUNCHES, k7b.BACKWARD_LAUNCHES)
    pts, hxe, hte = k7b.edge_points(spec, c, hx, ht, 4)
    ppts, phxe, phte = twf.edge_points_reference(spec, c, hx, ht, 4)
    assert torch.equal(pts, ppts) and torch.equal(hxe, phxe) and torch.equal(hte, phte)
    r = k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, 4)
    g_r = torch.from_numpy(np.random.default_rng(n).standard_normal(tuple(r.shape))
                           .astype(np.float32)).to(cuda_device)
    gy, gyx, gc = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, 4)
    gy2, gyx2, gc2 = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, 4)
    torch.cuda.synchronize()
    assert (k7b.EDGE_LAUNCHES, k7b.LAUNCHES, k7b.BACKWARD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2)
    assert torch.equal(gy, gy2) and torch.equal(gc, gc2)
    assert gyx is None if not viscous else torch.equal(gyx, gyx2)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        args = [t if t is None else t.to(dtype).clone().requires_grad_(True)
                for t in (y, yx, coeffs)]
        pr = _k7b_plain(kind, args[0], args[1], hxe.to(dtype), hte.to(dtype), args[2])
        wrt = [a for a in args if a is not None]
        grads = torch.autograd.grad(pr, wrt, g_r.to(dtype), allow_unused=True)
        outs[dtype] = [pr.detach()] + [torch.zeros_like(a) if g is None else g
                                       for g, a in zip(grads, wrt)]
    # (the plain Euler version takes gamma as a float: gamma - 1's gradient is 0)
    got = [r, gy] + ([gyx] if viscous else []) + [gc]
    for g, p, e in zip(got, outs[torch.float32], outs[torch.float64]):
        assert g.shape == p.shape
        _close_or_f64(g, p, e, wide=True)


def test_k7b_refuses_on_card_instead_of_falling_back(cuda_device):  # noqa: F811
    from pinns_tpu_torch.ops import weakform as twf
    from pinns_tpu_torch.ops.kernels import weakform as k7b

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    c, y, _, coeffs = _k7b_inputs("burgers", False, 8, cuda_device)
    with pytest.raises(ValueError, match="quadrature nodes"):
        k7b.edge_points(spec, c, 0.04, 0.02, 9)
    with pytest.raises(ValueError, match="float32"):
        k7b.edge_points(spec, c.double(), 0.04, 0.02, 4)
    h = torch.ones((8, 1), device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        k7b.flux_forward("burgers", y[:-1], None, h, h, coeffs, 4)
    # the entropy's backward needs the forward's e beside its cotangent
    with pytest.raises(ValueError, match="g_ent and e"):
        k7b.flux_backward("burgers", torch.zeros((8, 1), device=cuda_device), y, None, h, h,
                          coeffs, 4, g_ent=torch.zeros((8, 1), device=cuda_device))
    r, ent = twf.burgers_flux_residual(spec, init_mlp(spec, torch.Generator().manual_seed(1),
                                                      cuda_device), c, 1.0, 0.0, 0.04, 0.02, 4,
                                       want_entropy=True)
    assert ent.shape == (8, 1) and ent.device.type == "cuda"


@pytest.mark.parametrize("kind,viscous,n", K7B_CASES,
                         ids=[f"{k}-{'visc' if v else 'invisc'}-n{n}" for k, v, n in K7B_CASES])
def test_k7b_entropy_matches_plain_on_card(cuda_device, kind, viscous, n):  # noqa: F811
    """K7b's entropy mode: r bit-equal to the mode without it, relu(e)^2 and
    the backward with both cotangents within the float64 criterion of the
    plain quadrature with want_entropy (autograd through it), two calls bit
    for bit, one launch counted in each entropy counter."""
    from pinns_tpu_torch.ops import weakform as twf
    from pinns_tpu_torch.ops.kernels import weakform as k7b

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    c, y, yx, coeffs = _k7b_inputs(kind, viscous, n, cuda_device)
    gamma = float(coeffs[0]) + 1.0 if kind == "euler" else 1.4
    _, hxe, hte = k7b.edge_points(spec, c, 0.02 * (UB[0] - LB[0]), 0.02 * (UB[1] - LB[1]), 4)
    counts = (k7b.ENTROPY_LAUNCHES, k7b.ENTROPY_BACKWARD_LAUNCHES)
    r, ent, e = k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, 4, True, gamma)
    assert torch.equal(r, k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, 4))
    rng = np.random.default_rng(n + 1)
    g_r = torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(np.float32)).to(cuda_device)
    g_ent = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(cuda_device)
    got = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, 4, g_ent, e, gamma)
    again = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, 4, g_ent, e, gamma)
    torch.cuda.synchronize()
    assert (k7b.ENTROPY_LAUNCHES, k7b.ENTROPY_BACKWARD_LAUNCHES) == (counts[0] + 1,
                                                                     counts[1] + 2)
    assert all(a is b or torch.equal(a, b) for a, b in zip(got, again))
    outs = {}
    for dtype in (torch.float32, torch.float64):
        args = [t if t is None else t.to(dtype).clone().requires_grad_(True)
                for t in (y, yx, coeffs)]
        h = (hxe.to(dtype), hte.to(dtype))
        if kind == "burgers":
            pr, pent = twf.burgers_quadrature_reference(args[0], args[1], *h, args[2][0],
                                                        args[2][1], 4, True)
        else:
            rs, pent = twf.euler_quadrature_reference(args[0], args[1], *h, gamma, args[2][1],
                                                      4, True)
            pr = torch.cat(rs, dim=1)
        wrt = [a for a in args if a is not None]
        loss = torch.sum(pr * g_r.to(dtype)) + torch.sum(pent * g_ent.to(dtype))
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        outs[dtype] = [pent.detach()] + [torch.zeros_like(a) if g is None else g
                                         for g, a in zip(grads, wrt)]
    gy, gyx, gc = got
    for g, p, x in zip([ent, gy] + ([gyx] if viscous else []) + [gc], outs[torch.float32],
                       outs[torch.float64]):
        assert g.shape == p.shape
        _close_or_f64(g, p, x, wide=True)


def test_euler_tail_runs_k10_on_card(cuda_device):  # noqa: F811
    """euler_weak_tail's L-BFGS outer epoch on the card (a 2x48 path trunk:
    K5's wide design, the one that takes shock paths; N_f 64) takes
    AutogradLBFGS: K10's reset, control and direction kernels, one solve
    counted, no host loop; its iterations equal the host loop's on the
    card (host_loop=True) and its loss agrees."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("euler_weak_tail"), {
        "model.layers": (2, 48, 48, 3), "sampling.n_f": 64, "data.n_u": 64,
        "optimizer.lbfgs.max_iters": 5})
    trainer = tr.Trainer(exp, device="cuda")
    state = trainer.init_state()
    step = trainer._lbfgs_step
    assert isinstance(step.solver, k_lbfgs.AutogradLBFGS)
    before = (k_lbfgs.SOLVES, k_lbfgs.RESET_LAUNCHES, k_lbfgs.DIRECTION_LAUNCHES)
    new, m = step(state)
    torch.cuda.synchronize()
    after = (k_lbfgs.SOLVES, k_lbfgs.RESET_LAUNCHES, k_lbfgs.DIRECTION_LAUNCHES)
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1 and after[2] > before[2]
    assert step.solver.captured and step.solver.loop.loop is not None
    host = tr.make_lbfgs_step(trainer.problem, host_loop=True)
    assert host.solver is None
    _, hm = host(state)
    assert float(m["lbfgs_iters"]) == float(hm["lbfgs_iters"])
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(hm["loss"]), rtol=1e-4)


def test_k7a_at_the_twosin_weak_shape(cuda_device):  # noqa: F811
    """K7a at 8x20, out 1, 16,000 edge points (twosin_weak's residual pass)
    against float64, forward and backward."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference

    layers, n = (2,) + (20,) * 8 + (1,), 16_000
    spec, params, spec64, params64 = _net(layers, 21, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=22)).to(cuda_device)
    rng = np.random.default_rng(23)
    cot = [torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(cuda_device)
           for _ in range(3)]
    outs = k_taylor1.taylor1(spec, params, x)
    grad = k_taylor1.taylor1_backward(spec, params, x, cot)
    plain = mlp_taylor_1_reference(spec, params, x)
    exact = mlp_taylor_1_reference(spec64, params64, x.double())
    for g, p, e in zip(outs, plain, exact):
        _f64_oracle(g.double().cpu(), p.double().cpu(), e.cpu())
    pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
    egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                 [c.double() for c in cot])
    off = 0
    for p, e in zip(pgrad, egrad):
        _close_or_f64(grad[off:off + p.numel()].view(p.shape), p, e, wide=True)
        off += p.numel()


@pytest.mark.parametrize("preset", ["twosin_weak", "euler_inverse"])
def test_weak_trainer_on_card(cuda_device, preset):  # noqa: F811
    """A few epochs of each weak-form preset on the card: every epoch runs
    K7b's three calls around K7a, and K5 for the data term; no plain call."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import weakform as k7b
    from pinns_tpu_torch.train.trainer import Trainer

    epochs = 6
    exp = override(get_preset(preset), {"train.epochs": epochs, "train.chunk": 3,
                                        "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    before = (k7b.EDGE_LAUNCHES, k7b.LAUNCHES, k7b.BACKWARD_LAUNCHES,
              k_taylor1.BACKWARD_LAUNCHES, k_mlp.BACKWARD_LAUNCHES)
    state, summary = trainer.train()
    after = (k7b.EDGE_LAUNCHES, k7b.LAUNCHES, k7b.BACKWARD_LAUNCHES,
             k_taylor1.BACKWARD_LAUNCHES, k_mlp.BACKWARD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [epochs] * 5
    fields = ("u",) if preset == "twosin_weak" else ("rho", "u", "E")
    assert all(np.isfinite(summary[f"rel_l2_{f}"]) for f in fields)
    assert np.isfinite(summary["lambda2"]) and summary["lambda2"] > 0


K8S_SHAPES = [((2,) + (20,) * 8 + (1,), e, n) for e in (1, 3, 8) for n in (1, 31, 2_000)] + \
    [(WIDE, e, n) for e in (1, 3) for n in (1, 31, 2_000)]


@pytest.mark.parametrize("layers,e,n", K8S_SHAPES,
                         ids=[f"{max(l)}w-e{e}-n{n}" for l, e, n in K8S_SHAPES])
def test_k8s_members_equal_solo_k1_on_card(cuda_device, layers, e, n):  # noqa: F811
    """K8s (a): every member's four streams from one member-batched K1
    launch equal a solo K1 call on its net bit for bit, narrow and tiled."""
    from pinns_tpu_torch.parallel.ensemble import pack_members

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    nets = [init_mlp(spec, torch.Generator().manual_seed(30 + m), cuda_device)
            for m in range(e)]
    x = torch.from_numpy(numpy_points(n, seed=31)).to(cuda_device)
    before = k_taylor2.MEMBER_LAUNCHES
    got = k_taylor2.taylor2_members(spec, pack_members(nets), x)
    torch.cuda.synchronize()
    assert k_taylor2.MEMBER_LAUNCHES == before + 1
    for m, net in enumerate(nets):
        for g, s in zip(got, k_taylor2.taylor2(spec, net, x)):
            assert g.shape == (e, n, 1) and torch.equal(g[m], s), m


@pytest.mark.parametrize("e,dx", [(3, True), (8, True), (8, False), (1, True)])
def test_k8s_reduction_on_card(cuda_device, e, dx):  # noqa: F811
    """K8s (c): mean, population std and |mean dx| against float64, within
    4x the plain float32 version's error plus 1e-6 max|exact|; members that
    agree to 1e-4, where a one-pass variance would cancel."""
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens

    rng = np.random.default_rng(32 + e)
    base = rng.standard_normal((1, 4_099, 3))
    vals = torch.from_numpy((base + 1e-4 * rng.standard_normal((e, 4_099, 3))).astype(
        np.float32)).to(cuda_device)
    dxs = torch.from_numpy(rng.standard_normal((e, 4_099, 2)).astype(np.float32)).to(
        cuda_device) if dx else None
    before = k_ens.LAUNCHES
    got = k_ens.member_stats(vals, dxs)
    torch.cuda.synchronize()
    assert k_ens.LAUNCHES == before + 1
    plain = k_ens.member_stats_reference(vals, dxs)
    exact = k_ens.member_stats_reference(vals.double(), None if dxs is None else dxs.double())
    for g, p, x in zip(got, plain, exact):
        if x is None:
            assert g is None and p is None
            continue
        err = float((g.double() - x).abs().max())
        plain_err = float((p.double() - x).abs().max())
        assert err <= 4.0 * plain_err + 1e-6 * float(x.abs().max())


def _member_stats_spelled(vals, dxs):
    """K8s (c)'s arithmetic spelled in plain PyTorch, one float32 op at a
    time in member order (each op its own kernel: no contraction)."""
    e = vals.shape[0]
    s = torch.zeros_like(vals[0])
    for k in range(e):
        s = s + vals[k]
    # a tensor divisor: PyTorch divides by a CPU scalar as a product with its
    # reciprocal, which is not the division the kernel does
    fe = torch.full_like(s, e)
    mu = s / fe
    q = torch.zeros_like(mu)
    for k in range(e):
        t = vals[k] - mu
        q = q + t * t
    std = torch.sqrt(q / fe)
    if dxs is None:
        return mu, std, None
    sd = torch.zeros_like(dxs[0])
    for k in range(e):
        sd = sd + dxs[k]
    return mu, std, torch.abs(sd / torch.full_like(sd, e))


K8S_REDUCE_CASES = [(e, n, c, cd) for e in (1, 3, 8, 32, 33) for n, c, cd in
                    ((4_099, 3, 2), (4_100, 6, 3), (4_097, 1, 1))]


@pytest.mark.parametrize("e,n,c,cd", K8S_REDUCE_CASES,
                         ids=[f"e{e}-n{n}-c{c}-d{cd}" for e, n, c, cd in K8S_REDUCE_CASES])
def test_k8s_reduction_bits_on_card(cuda_device, e, n, c, cd):  # noqa: F811
    """K8s (c) at E 1, 3, 8, 32 (members in registers) and 33 (two reads),
    with N C and N Cd multiples of 4 (16-byte loads) or not: equal bit for
    bit to its arithmetic spelled in plain PyTorch in member order, and
    within 4x the plain float32 error of float64."""
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens

    rng = np.random.default_rng(40 + e)
    base = rng.standard_normal((1, n, c))
    vals = torch.from_numpy((base + 1e-4 * rng.standard_normal((e, n, c))).astype(
        np.float32)).to(cuda_device)
    dxs = torch.from_numpy(rng.standard_normal((e, n, cd)).astype(np.float32)).to(cuda_device)
    for dx in (dxs, None):
        got = k_ens.member_stats(vals, dx)
        spelled = _member_stats_spelled(vals, dx)
        plain = k_ens.member_stats_reference(vals, dx)
        exact = k_ens.member_stats_reference(vals.double(), None if dx is None else dx.double())
        torch.cuda.synchronize()
        for g, w, p, x in zip(got, spelled, plain, exact):
            if x is None:
                assert g is None
                continue
            assert torch.equal(g, w)
            err = float((g.double() - x).abs().max())
            assert err <= 4.0 * float((p.double() - x).abs().max()) + 1e-6 * float(x.abs().max())


def test_served_ensemble_on_card(cuda_device, tmp_path):  # noqa: F811
    """A calibrated ensemble artifact served on the card: K8s (a) once, K7a
    once a member for dx, K8s (c) once a predict; the outputs against the
    same artifact served by the plain versions on the CPU."""
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.serve import export_ensemble

    spec = MLPSpec(layers=(2,) + (20,) * 8 + (1,), lb=LB, ub=UB)
    nets = [init_mlp(spec, torch.Generator().manual_seed(40 + m), torch.device("cpu"))
            for m in range(4)]
    cal = {"u": {"k_conf95": 3.0, "mond_edges": [0.1, 0.5, 1.0], "mond_k": [2.0, 3.0, 4.0, 5.0],
                 "mond_feature": "dx"}}
    art = export_ensemble(spec, nets, str(tmp_path / "ens"), [1.0, 1.1, 1.2, 1.3],
                          [0.003] * 4, experiment="burgers_forward", calibration=cal)
    x = numpy_points(3_000, seed=41)
    before = (k_taylor2.MEMBER_LAUNCHES, k_taylor1.LAUNCHES, k_ens.LAUNCHES)
    served = ServedModel(art, device=cuda_device)
    out = served.add_bands(served.predict(x, pad_to_bucket=True))
    after = (k_taylor2.MEMBER_LAUNCHES, k_taylor1.LAUNCHES, k_ens.LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 4, 1]
    want = ServedModel(art, device="cpu")
    want = want.add_bands(want.predict(x))
    assert sorted(out) == sorted(want) == ["f", "f_std", "u", "u_band", "u_dx", "u_std"]
    for k in want:
        name = k.split("_")[0]
        atol = (1e-4 if name == "f" else 1e-5) * float(np.abs(want[name]).max())
        np.testing.assert_allclose(out[k], want[k], rtol=1e-4, atol=atol, err_msg=k)


# -- K10: the L-BFGS solve on the device -----------------------------------------

LBFGS_FIXTURE = os.path.join(os.path.dirname(FIXTURE), "lbfgs_hybrid.npz")
STEPS_FIXTURE = os.path.join(os.path.dirname(FIXTURE), "abgrall_admm_steps.npz")


def _k10_fixture_state(device):
    """The abgrall_admm problem on the card and the JAX state the L-BFGS
    fixture starts from: (problem, params, colloc, admm, lbfgs fixture)."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.ops.kernels.fused_step import unpack_params
    from pinns_tpu_torch.train import trainer as tr

    with np.load(STEPS_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    with np.load(LBFGS_FIXTURE) as z:
        lb = {k: z[k] for k in z.files}
    k = int(lb["replay_step"])
    problem = tr.build_problem(get_preset("abgrall_admm"), device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    params = {"net": unpack_params(t(fx[f"params_{k}"]), problem.spec.layers),
              "coeffs": {"lambda1": torch.full((1,), float(fx["lambda1"]), device=device),
                         "lambda2": torch.full((1,), float(fx["lambda2"]), device=device)}}
    return problem, params, t(fx[f"colloc_{k}"]), ADMMState(z=t(fx[f"z_{k}"]),
                                                              dual=t(fx[f"dual_{k}"])), lb


@pytest.mark.parametrize("kind,explicit_inner", [("admm", False), ("admm", True), ("mean_sq", False),
                                                 ("l2_sq_norm", False), ("l1_sq_norm", False)])
@pytest.mark.parametrize("layers,n_f", [(NARROW, 1_000), ((2, 16, 16, 16, 1), 77)],
                         ids=["8x20-1000", "16-77"])
def test_k10_value_and_grad_on_card(cuda_device, layers, n_f, kind, explicit_inner):  # noqa: F811
    """K3's value-and-grad mode: its gradient and loss equal the Adam
    epoch's (want_grad; the same kernels) bit for bit, lie within the fused
    step's tolerance of the plain version, repeat bit for bit, and a set
    skip flag leaves both outputs untouched."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    net = init_mlp(spec, torch.Generator().manual_seed(3), cuda_device)
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data = t(numpy_points(n_f, seed=6)), t(numpy_points(13, seed=7))
    u_data = t(rng.standard_normal((13, 1)))
    z = t(0.1 * rng.standard_normal((n_f, 1))) if kind == "admm" else None
    dual = t(1 + 0.1 * rng.standard_normal((n_f, 1))) if kind == "admm" else None
    flat = pack_params(net)
    cfg = dict(kind=kind, lam1=0.9, lam2=0.01, rho=10.0, explicit_inner=explicit_inner)
    ep = k_fused.fused_adam_step(spec, flat, torch.zeros_like(flat), torch.zeros_like(flat), 0,
                                 x_data, u_data, colloc, z, dual, lr=1e-3, seed=9, epoch=5,
                                 want_grad=True, **cfg)
    outs = []
    before = k_fused.VALUE_AND_GRAD_LAUNCHES
    for _ in range(2):
        grad, loss = torch.full_like(flat, float("nan")), torch.full((1,), float("nan"),
                                                                    device=cuda_device)
        k_fused.fused_value_and_grad(spec, flat, grad, loss, x_data, u_data, colloc, z, dual,
                                     **cfg)
        outs.append((grad, loss))
    torch.cuda.synchronize()
    assert k_fused.VALUE_AND_GRAD_LAUNCHES == before + 2
    (grad, loss), (grad2, loss2) = outs
    assert torch.equal(grad, ep["grad"]) and float(loss) == float(ep["metrics"][5])
    assert torch.equal(grad, grad2) and torch.equal(loss, loss2)
    f, g = k_fused.value_and_grad_reference(spec, flat, x_data, u_data, colloc, z, dual, **cfg)
    np.testing.assert_allclose(float(loss), float(f), rtol=1e-4)
    off = 0
    for layer in net:
        for leaf in (layer["W"], layer["b"]):
            w = g[off:off + leaf.numel()].cpu().numpy()
            np.testing.assert_allclose(grad[off:off + leaf.numel()].cpu().numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())
            off += leaf.numel()
    skip = torch.ones(1, dtype=torch.int32, device=cuda_device)
    g3, l3 = grad.clone(), loss.clone()
    k_fused.fused_value_and_grad(spec, flat + 1.0, g3, l3, x_data, u_data, colloc, z, dual,
                                 skip=skip, **cfg)
    torch.cuda.synchronize()
    assert torch.equal(g3, grad) and torch.equal(l3, loss)


def _k10_lockstep(b, evaluate, steps: int, direction=None) -> dict:
    """``steps`` evaluation steps through the kernels (the direction kernel
    through ``direction``, a launch of another design, when given), each
    kernel beside its plain version on a copy of the same state: every
    buffer equal bit for bit after every launch. Returns the branches taken
    and the steps run."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    ran = 0
    for _ in range(steps):
        evaluate()
        for kernel, plain in ((k_lbfgs.control, k_lbfgs.control_reference),
                              (direction or k_lbfgs.direction, k_lbfgs.direction_reference)):
            twin = b.clone()
            kernel(b)
            plain(twin)
            torch.cuda.synchronize()
            for name, got, want in zip(("si", "sf", "vec", "hist", "rho"),
                                       (b.si, b.sf, b.vec, b.hist, b.rho),
                                       (twin.si, twin.sf, twin.vec, twin.hist, twin.rho)):
                assert torch.equal(got, want), (kernel.__name__, ran, name)
        ran += 1
        if int(b.si[k_lbfgs.I_DONE]):
            break
    return {"branches": k_lbfgs.branches_taken(b), "steps": ran}


def test_k10_kernels_equal_their_plain_versions_on_card(cuda_device):  # noqa: F811
    """The control and direction kernels against their plain versions, bit
    for bit, step by step, at abgrall_admm's 8x20 from the fixture's state
    (K3's value-and-grad, 40 steps); the reset kernel against its plain
    version."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree

    problem, params, colloc, admm, _ = _k10_fixture_state(cuda_device)
    x0, _ = ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    b = k_lbfgs.Buffers.alloc(x0.numel(), 50, cuda_device)
    twin = b.clone()
    k_lbfgs.reset(b, x0, max_iters=5000)
    k_lbfgs.reset_reference(twin, x0, 5000, 50, k_lbfgs.solve_constants())
    assert all(torch.equal(u, v) for u, v in zip((b.si, b.sf, b.vec), (twin.si, twin.sf, twin.vec)))
    cfg = k_fused.loss_config(problem.exp)

    def k3():
        k_fused.fused_value_and_grad(
            problem.spec, b.vec[k_lbfgs.XT, off:], b.vec[k_lbfgs.GT, off:],
            b.sf[k_lbfgs.F_PHI_T:k_lbfgs.F_PHI_T + 1], problem.x_data,
            problem.targets["u"].contiguous(), colloc, admm.z, admm.dual, rho=10.0,
            skip=b.si[:1], **cfg)

    run = _k10_lockstep(b, k3, 40)
    assert {"accept", "stored"} <= set(run["branches"]) and int(b.si[k_lbfgs.I_K]) >= 10


@pytest.mark.parametrize("n", [5, 1_500, 7_000, 9_000])
def test_k10_direction_paths_equal_plain_on_card(cuda_device, n):  # noqa: F811
    """The direction kernel's two-loop in registers (1, 2 and 8 entries a
    thread) and in shared memory (above 8,192 entries) against the plain
    versions, bit for bit after every launch, with a history of 3 that fills
    and wraps: a Rosenbrock (n 5) or a quartic valley (autograd's
    value-and-grad)."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import value_and_grad

    rng = np.random.default_rng(n)
    if n == 5:
        x0 = torch.tensor([-1.2, 1.0, -1.2, 1.0, 0.5], device=cuda_device)
        fun = lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2  # noqa: E731
                                  + (1.0 - x[:-1]) ** 2)
    else:
        a = torch.from_numpy(rng.uniform(0.5, 5.0, n).astype(np.float32)).to(cuda_device)
        c = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device)
        x0 = torch.zeros(n, device=cuda_device)
        fun = lambda x: torch.sum(a * (x - c) ** 2 + 0.1 * (x - c) ** 4)  # noqa: E731
    vg = value_and_grad(fun)
    r = k_lbfgs.Buffers.alloc(n, 3, cuda_device)
    k_lbfgs.reset(r, x0, max_iters=12, gtol=0.0)

    def evaluate():
        if not int(r.si[k_lbfgs.I_DONE]):
            f, g = vg(r.vec[k_lbfgs.XT].clone())
            r.sf[k_lbfgs.F_PHI_T] = f
            r.vec[k_lbfgs.GT].copy_(g)

    run = _k10_lockstep(r, evaluate, 200)
    assert int(r.si[k_lbfgs.I_K]) > 4 and int(r.si[k_lbfgs.I_COUNT]) == 3, run


def test_k10_solve_on_card(cuda_device):  # noqa: F811
    """DeviceLBFGS from the fixture's state: JAX's n_iters at 1, 2 and 5
    iterations with x within chip_smoke.py's phase-13 bound; two solves bit
    for bit; the solve's one launch of its WHILE node equal to the same
    steps through the wrappers one launch at a time (the stepwise drive) in
    every buffer; one device read and at most k - 1 steps after the end a
    solve."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree

    problem, params, colloc, admm, fx = _k10_fixture_state(cuda_device)
    x0, _ = ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    solver = k_lbfgs.DeviceLBFGS(problem)
    x0_np = fx["x0"].astype(np.float64)
    assert np.array_equal(x0.cpu().numpy(), fx["x0"])
    for k in (1, 2, 5):
        before = (k_lbfgs.LOOP_LAUNCHES, host_lbfgs.HOST_SYNCS, k_lbfgs.STEPS_AFTER_END)
        res = solver.minimize(x0, off, colloc, admm, 10.0, max_iters=k)
        after = (k_lbfgs.LOOP_LAUNCHES, host_lbfgs.HOST_SYNCS, k_lbfgs.STEPS_AFTER_END)
        assert after[0] - before[0] == after[1] - before[1] == 1
        assert after[2] - before[2] < solver.steps
        want = fx[f"x_{k}"].astype(np.float64)
        err = float(np.abs(res.x.cpu().numpy() - want).max())
        bound = 1e-2 * float(np.abs(want - x0_np).max()) + 1e-6 * float(np.abs(want).max())
        assert err <= bound and res.n_iters == int(fx[f"n_iters_{k}"]), (k, err, bound, res)
    again = solver.minimize(x0, off, colloc, admm, 10.0, max_iters=5)
    assert torch.equal(again.x, res.x) and torch.equal(again.f, res.f)
    assert (again.n_iters, again.n_evals) == (res.n_iters, res.n_evals)

    b = k_lbfgs.Buffers.alloc(x0.numel(), 50, cuda_device)
    z, dual = admm.z.clone(), admm.dual.clone()

    def k3():
        k_fused.fused_value_and_grad(
            problem.spec, b.vec[k_lbfgs.XT, off:], b.vec[k_lbfgs.GT, off:],
            b.sf[k_lbfgs.F_PHI_T:k_lbfgs.F_PHI_T + 1], problem.x_data,
            problem.targets["u"].contiguous(), colloc, z, dual, rho=10.0, skip=b.si[:1],
            **k_fused.loss_config(problem.exp))

    k_lbfgs.reset(b, x0, max_iters=5)
    stepwise = k_lbfgs.run_steps(b, k3)
    assert torch.equal(stepwise.x, res.x) and stepwise.n_evals == res.n_evals
    loop, count = solver.bufs, int(b.si[k_lbfgs.I_COUNT])
    assert all(torch.equal(u, v) for u, v in zip((loop.si, loop.sf, loop.vec),
                                                 (b.si, b.sf, b.vec)))
    assert torch.equal(loop.hist[:, :count], b.hist[:, :count])
    assert torch.equal(loop.rho[:count], b.rho[:count])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("steps", [1, 4, 16])
def test_k10_loop_equals_the_stepwise_drive_on_card(cuda_device, steps, dtype):  # noqa: F811
    """AutogradLBFGS's captured solve (one launch of its WHILE node, k steps
    a body iteration) on a quartic valley equals the host-stepped drive over
    the same kernels in every buffer; one launch and one read a solve, at
    most k - 1 steps after its end, as the control kernel counts the steps
    on the device."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, 500)).to(cuda_device, dtype)
    c = torch.from_numpy(rng.standard_normal(500)).to(cuda_device, dtype)
    fun = lambda x: torch.sum(a * (x - c) ** 2 + 0.1 * (x - c) ** 4)  # noqa: E731
    x0 = torch.zeros(500, dtype=dtype, device=cuda_device)
    loop = k_lbfgs.AutogradLBFGS(steps=steps)
    before = (k_lbfgs.LOOP_LAUNCHES, host_lbfgs.HOST_SYNCS, k_lbfgs.STEPS_AFTER_END)
    got = loop.minimize(fun, x0, max_iters=40, history=8)
    after = (k_lbfgs.LOOP_LAUNCHES, host_lbfgs.HOST_SYNCS, k_lbfgs.STEPS_AFTER_END)
    assert after[0] - before[0] == after[1] - before[1] == 1
    assert after[2] - before[2] <= steps - 1
    assert int(loop.bufs.steps) == steps * -(-got.n_evals // steps)
    host = k_lbfgs.AutogradLBFGS(captured=False, sync_every=1)
    want = host.minimize(fun, x0, max_iters=40, history=8)
    assert got.n_iters > 5 and (got.n_iters, got.n_evals) == (want.n_iters, want.n_evals)
    assert int(host.bufs.steps) == want.n_evals
    assert all(torch.equal(u, v) for u, v in zip(loop.bufs.tensors(), host.bufs.tensors()))


def _k10_fixture_lockstep(cuda_device, m: int, steps: int, direction=None) -> dict:
    """The lockstep from the fixture's state at abgrall_admm's 8x20 (K3's
    value-and-grad) with a history of m; returns the run and the state."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree

    problem, params, colloc, admm, _ = _k10_fixture_state(cuda_device)
    x0, _ = ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    b = k_lbfgs.Buffers.alloc(x0.numel(), m, cuda_device)
    k_lbfgs.reset(b, x0, max_iters=5000)
    cfg = k_fused.loss_config(problem.exp)

    def k3():
        k_fused.fused_value_and_grad(
            problem.spec, b.vec[k_lbfgs.XT, off:], b.vec[k_lbfgs.GT, off:],
            b.sf[k_lbfgs.F_PHI_T:k_lbfgs.F_PHI_T + 1], problem.x_data,
            problem.targets["u"].contiguous(), colloc, admm.z, admm.dual, rho=10.0,
            skip=b.si[:1], **cfg)

    return _k10_lockstep(b, k3, steps, direction), b


def test_k10_resident_history_wraps_on_card(cuda_device):  # noqa: F811
    """The resident design (the pairs in the 8 CTAs' shared memory) at
    abgrall_admm's 3,023 params with a history of 8 that fills and whose
    head wraps: both kernels equal their plain versions after every launch."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    assert k_lbfgs.cluster_plan(3_023, 8).resident
    run, b = _k10_fixture_lockstep(cuda_device, 8, 40)
    assert int(b.si[k_lbfgs.I_COUNT]) == 8 and int(b.si[k_lbfgs.I_K]) > 9, run


@pytest.mark.parametrize("count", [0, 3, 50])
def test_k10_descent_guard_on_card(cuda_device, count):  # noqa: F811
    """The direction kernel takes the descent guard (a seeded history with a
    negative gamma) and equals its plain version bit for bit, at an empty,
    a partial and a full history."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    b = k_lbfgs.seeded_state(3_023, 50, count, 9, seed=count, device=cuda_device, gamma=-1.0)
    twin = b.clone()
    k_lbfgs.direction(b)
    k_lbfgs.direction_reference(twin)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))
    assert k_lbfgs.branches_taken(b) == ["descent_guard"]


def test_k10_streamed_plan_on_card(cuda_device):  # noqa: F811
    """The streamed design at the scope's largest net (31,811 params, 32
    entries a thread, q in shared memory) with a history of 50: a quartic
    valley's lockstep, both kernels equal to their plain versions after
    every launch; a full seeded history through the direction kernel too."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import value_and_grad

    n = 31_811
    assert not k_lbfgs.cluster_plan(n, 50).resident
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, n).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device)
    vg = value_and_grad(lambda x: torch.sum(a * (x - c) ** 2 + 0.1 * (x - c) ** 4))
    r = k_lbfgs.Buffers.alloc(n, 50, cuda_device)
    k_lbfgs.reset(r, torch.zeros(n, device=cuda_device), max_iters=8, gtol=0.0)

    def evaluate():
        if not int(r.si[k_lbfgs.I_DONE]):
            f, g = vg(r.vec[k_lbfgs.XT].clone())
            r.sf[k_lbfgs.F_PHI_T] = f
            r.vec[k_lbfgs.GT].copy_(g)

    run = _k10_lockstep(r, evaluate, 100)
    assert int(r.si[k_lbfgs.I_K]) > 4 and "stored" in run["branches"], run
    b = k_lbfgs.seeded_state(n, 50, 50, 7, seed=3, device=cuda_device)
    twin = b.clone()
    k_lbfgs.direction(b)
    k_lbfgs.direction_reference(twin)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))


@pytest.mark.parametrize("resident", [True, False])
def test_k10_cluster_layouts_on_card(cuda_device, resident):  # noqa: F811
    """Both designs phase 37 of chip_smoke.py times at the fixture's 3,023
    params (the pairs resident, the plan's; or streamed) keep the plain
    versions' bits over 30 steps from the fixture's state."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    plan = k_lbfgs.ClusterPlan(resident, 3, k_lbfgs.direction_smem(3_023, 50, resident))
    assert k_lbfgs.cluster_plan(3_023, 50).resident

    def direction(b):
        k_lbfgs._launch_direction(b, plan=plan)

    run, b = _k10_fixture_lockstep(cuda_device, 50, 30, direction)
    assert {"accept", "stored"} <= set(run["branches"]), run


@pytest.mark.parametrize("count", [0, 50])
def test_k10_reset_in_place_on_card(cuda_device, count):  # noqa: F811
    """The reset kernel in place (no x0: the iterate vec[X] stays, the trial
    point takes it) equals reset_reference from a copy of vec[X] bit for
    bit on every buffer, the history left as it was."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    b = k_lbfgs.seeded_state(3_023, 50, count, 9, seed=count, device=cuda_device)
    b.vec[k_lbfgs.GT].fill_(5.0)
    twin = b.clone()
    k_lbfgs.reset(b, None, max_iters=300, max_ls=50, ftol=1e-12, gtol=1e-7)
    k_lbfgs.reset_reference(twin, twin.vec[k_lbfgs.X].clone(), 300, 50,
                            k_lbfgs.solve_constants(ftol=1e-12, gtol=1e-7))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))


@pytest.mark.parametrize("kind,fixed", [("admm", False), ("admm", True), ("mean_sq", False)],
                         ids=["drawn_admm", "fixed_admm", "drawn_mean_sq"])
def test_post_update_mode_on_card(cuda_device, kind, fixed):  # noqa: F811
    """K3's post-update mode at the fixture's state (8x20, N_f 1,000, N_u
    100) against its plain version on the same card tensors: the batch
    philox_uniform's bit for bit (or the fixed batch kept), z, dual and the
    misfit within the fused step's tolerance (STEP_TOL of chip_smoke.py,
    the dual's atol scaled by the terms its update cancels), the data term
    within rtol 1e-5, the rest of the metrics row exact, one row written,
    the cursor moved on; two calls bit-equal."""
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.train.trainer import METRIC_KEYS

    problem, params, colloc, admm, _ = _k10_fixture_state(cuda_device)
    x0, _ = ravel_tree(params)
    off = k_lbfgs.net_offset(params)
    n_f = colloc.shape[0]
    sched = torch.from_numpy(k_fused.chunk_schedule(0, 11, 2)).to(cuda_device)
    table = k_fused.member_table([99], [10.0], n_f, cuda_device)

    def run(fn):
        b = {"colloc": colloc.clone(), "metrics": torch.zeros(2, 7, device=cuda_device),
             "cursor": torch.ones(1, dtype=torch.int32, device=cuda_device),
             "z": admm.z.clone() if kind == "admm" else None,
             "dual": admm.dual.clone() if kind == "admm" else None}
        fn(problem.spec, x0[off:], problem.x_data, problem.targets["u"].contiguous(),
           b["colloc"], b["z"], b["dual"], b["metrics"], b["cursor"], sched, table,
           torch.full((1,), 0.25, device=cuda_device),
           torch.full((1,), 40, dtype=torch.int32, device=cuda_device), kind=kind, lam1=1.0,
           lam2=0.0, fixed=fixed)
        torch.cuda.synchronize()
        return b

    got, again, plain = (run(k_fused.fused_post_update), run(k_fused.fused_post_update),
                         run(k_fused.post_update_reference))
    want_batch = colloc if fixed else philox_uniform(99, 13, n_f, problem.spec.lb,
                                                     problem.spec.ub, torch.float32, cuda_device)
    assert torch.equal(got["colloc"], want_batch) and torch.equal(plain["colloc"], want_batch)
    assert all(v is None or torch.equal(v, again[k]) for k, v in got.items())
    g, p = got["metrics"][1].tolist(), plain["metrics"][1].tolist()
    m, w = dict(zip(METRIC_KEYS, g)), dict(zip(METRIC_KEYS, p))
    if kind == "admm":
        zmax = float(plain["z"].abs().max())
        np.testing.assert_allclose(got["z"].cpu().numpy(), plain["z"].cpu().numpy(), rtol=1e-4,
                                   atol=1e-5 * zmax)
        np.testing.assert_allclose(got["dual"].cpu().numpy(), plain["dual"].cpu().numpy(),
                                   rtol=1e-4,
                                   atol=1e-5 * (float(admm.dual.abs().max()) + 10.0 * zmax))
        np.testing.assert_allclose(m["admm_misfit"], w["admm_misfit"], rtol=1e-4,
                                   atol=1e-6 * zmax)
    else:
        assert m["admm_misfit"] == 0.0
    np.testing.assert_allclose(m["data_term"], w["data_term"], rtol=1e-5)
    assert (m["loss"], m["lbfgs_iters"], m["lambda1"], m["lambda2"]) == (0.25, 40.0, 1.0, 0.0)
    assert m["res_term"] == float(np.float32(0.25) - np.float32(m["data_term"]))
    assert float(got["metrics"][0].abs().max()) == 0.0 and int(got["cursor"][0]) == 2


@pytest.mark.parametrize("fed", [False, True], ids=["drawn", "fed"])
def test_lbfgs_chunk_equals_one_epoch_chunks_on_card(cuda_device, fed):  # noqa: F811
    """K10's runner at the fixture's state (abgrall_admm 8x20, at most 20
    iterations an outer epoch): a chunk of 3 outer epochs equals 3 chunks
    of one bit for bit (x, batch, z, dual, every metrics row); every solve
    and post-update launched, one device read a chunk, no K1 or K5
    launch."""
    import dataclasses

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.train import trainer as tr

    problem, params, colloc, admm, _ = _k10_fixture_state(cuda_device)
    problem = dataclasses.replace(problem, exp=override(problem.exp, {
        "optimizer.lbfgs.max_iters": 20}))
    runner = k_lbfgs.LBFGSChunk(problem, max_len=3)
    state = tr.TrainState(params=params, opt_state=None, admm=admm, colloc=colloc, key=1234,
                          epoch=5, rho=None)
    feed = torch.from_numpy(np.stack([numpy_points(colloc.shape[0], seed=s) for s in range(3)])
                            ).to(cuda_device) if fed else None
    before = (k_lbfgs.CHUNK_EPOCHS, k_fused.POST_UPDATE_LAUNCHES, k_lbfgs.LOOP_LAUNCHES,
              host_lbfgs.HOST_SYNCS, k_taylor2.LAUNCHES, k_mlp.LAUNCHES)
    got, gm = runner.run(state, 3, feed)
    one, rows = state, []
    for i in range(3):
        one, m = runner.run(one, 1, None if feed is None else feed[i:i + 1])
        rows.append(m)
    torch.cuda.synchronize()
    after = (k_lbfgs.CHUNK_EPOCHS, k_fused.POST_UPDATE_LAUNCHES, k_lbfgs.LOOP_LAUNCHES,
             host_lbfgs.HOST_SYNCS, k_taylor2.LAUNCHES, k_mlp.LAUNCHES)
    d = [a - b for a, b in zip(after, before)]
    # one loop launch an outer epoch, one device read a chunk (after it)
    assert d[0] == d[1] == d[2] == 6 and d[3] == 4 and d[4] == d[5] == 0, d
    assert torch.equal(ravel_tree(got.params)[0], ravel_tree(one.params)[0])
    assert torch.equal(got.colloc, one.colloc) and torch.equal(got.admm.z, one.admm.z)
    assert torch.equal(got.admm.dual, one.admm.dual)
    assert all(torch.equal(gm[k], torch.cat([m[k] for m in rows])) for k in gm)
    assert not fed or torch.equal(got.colloc, feed[-1])
    assert got.epoch == one.epoch == 8 and all(0 < v <= 20 for v in gm["lbfgs_iters"].tolist())


# -- K11 and K9 for the generic step ---------------------------------------------

@pytest.mark.parametrize("n", [1_000, 1_048_576])
@pytest.mark.parametrize("epoch", [0, 1, 2**32 + 5])
def test_generic_k11_matches_philox_uniform_on_card(cuda_device, n, epoch):  # noqa: F811
    """K11 draws philox_uniform's points bit for bit from the schedule row at
    the device cursor (the bounds of a curriculum row), in one launch."""
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.ops.kernels import sampling as k_sampling
    from pinns_tpu_torch.train import schedule

    lb, ub = (-1.0, 0.0), (1.0, float(np.float32(0.37)))
    rows = np.concatenate([schedule.schedule_rows(1234, 0, e, 1, 1e-3, lambda e: (lb, ub))
                           for e in (7, epoch - 1)])
    sched = torch.from_numpy(rows).to(cuda_device)
    cursor = torch.ones(1, dtype=torch.int64, device=cuda_device)
    before = k_sampling.LAUNCHES
    for dtype in (torch.float32, torch.float64):
        got = k_sampling.philox_draw(sched, cursor, n, dtype)
        want = philox_uniform(1234, epoch, n, lb, ub, dtype, cuda_device)
        torch.cuda.synchronize()
        assert torch.equal(got, want), dtype
    assert k_sampling.LAUNCHES == before + 2
    assert torch.equal(got.cpu(), philox_uniform(1234, epoch, n, lb, ub, torch.float64))


def _generic_tensors(state):
    from pinns_tpu_torch.opt.adam import tree_leaves

    admm = [] if state.admm is None else [state.admm.z, state.admm.dual]
    return tree_leaves([state.params, state.opt_state.mu, state.opt_state.nu, admm,
                        state.colloc])


def _assert_same_generic_chunk(a, b):
    (sa, ma), (sb, mb) = a, b
    assert (sa.epoch, sa.opt_state.count) == (sb.epoch, sb.opt_state.count)
    ta, tb = _generic_tensors(sa), _generic_tensors(sb)
    assert len(ta) == len(tb)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


@pytest.mark.parametrize("preset", ["euler_admm", "twosin_weak", "euler_weak_fast",
                                    "burgers_forward"])
def test_generic_chunk_equals_the_loop_on_card(cuda_device, preset):  # noqa: F811
    """K9 for the generic step: the chunk replayed from one captured epoch
    equals the per-epoch loop bit for bit (L 1, 2, 7; two chunks against
    one; fed), every epoch in a replay and none through the step's host
    call; the ensemble's member loop runs each member through the solo
    runner."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import generic_chunk as k_generic
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset(preset), {"sampling.n_f": 200, "train.chunk": 8})
    trainer = tr.Trainer(exp, device="cuda")
    run = trainer._get_chunk("adam")
    assert isinstance(run.runner, k_generic.GenericChunk)
    state = trainer.init_state()
    for length in (1, 2, 7):
        before = k_generic.GRAPH_EPOCHS
        got = run(state, length)
        assert k_generic.GRAPH_EPOCHS == before + length
        _assert_same_generic_chunk(got, tr.run_chunk(trainer._adam_step, state, length))
    half, _ = run(state, 3)
    whole, _ = run(state, 6)
    _assert_same_generic_chunk(run(half, 3), tr.run_chunk(trainer._adam_step, half, 3))
    assert all(torch.equal(a, b) for a, b in zip(_generic_tensors(run(half, 3)[0]),
                                                  _generic_tensors(whole)))
    n = state.colloc.shape[0]
    feed = torch.from_numpy(np.stack([numpy_points(n, seed=s) for s in range(5)])).to(
        cuda_device)
    _assert_same_generic_chunk(run(state, 5, new_colloc=feed),
                               tr.run_chunk(trainer._adam_step, state, 5, new_colloc=feed))
    other = trainer.init_state(seed=7)
    _assert_same_generic_chunk(run(other, 11), tr.run_chunk(trainer._adam_step, other, 11))


def test_rad_resample_on_card(cuda_device):  # noqa: F811
    """RAD on the card: p through K1 within rtol 1e-5 of the plain p on the
    same pool; the redraw's points are pool points (drawn by K11), the batch
    on the card, ADMM re-initialised at them."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import sampling as k_sampling
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("hwan_admm"), {"sampling.strategy": "rad", "sampling.n_f": 2048,
                                            "sampling.rad_pool_factor": 4})
    trainer = tr.Trainer(exp, device="cuda")
    problem, state = trainer.problem, trainer.init_state()
    pool = philox_uniform(5, 7, 8192, problem.lb, problem.ub, torch.float32, "cuda")
    with torch.no_grad():
        p = tr.rad_probabilities(problem, state.params, pool)
        plain = tr.rad_probabilities(problem, state.params, pool, plain=True)
    torch.testing.assert_close(p, plain, rtol=1e-5, atol=0)
    before = (k_taylor2.LAUNCHES, k_sampling.LAUNCHES)
    new = tr.rad_resample(problem, state)
    torch.cuda.synchronize()
    assert k_taylor2.LAUNCHES > before[0] and k_sampling.LAUNCHES == before[1] + 2
    lb, ub = tr._curriculum_bounds(problem, 0)
    pool = philox_uniform(state.key, tr.RAD_POOL, 8192, lb, ub, torch.float32, "cuda")
    idx = torch.cdist(new.colloc, pool, compute_mode="donot_use_mm_for_euclid_dist").argmin(1)
    assert torch.equal(pool.index_select(0, idx), new.colloc)
    z = problem.training_residuals(new.params, new.colloc)
    assert torch.equal(new.admm.z, z) and torch.equal(new.admm.dual, torch.ones_like(z))


def test_swa_trainer_on_card(cuda_device):  # noqa: F811
    """SWA on the card (twosin_weak on the graphed generic runner): the mean
    equals a plain float32 running mean of the same snapshots bit for bit."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("twosin_weak"), {"train.epochs": 40, "train.chunk": 10,
                                              "train.swa_frac": 0.5, "train.log_every": 0})
    trainer = tr.Trainer(exp, device="cuda")
    snaps, orig = [], tr.swa_update

    def spy(avg, n, params):
        snaps.append(tr.tree_map(torch.clone, params))
        return orig(avg, n, params)

    tr.swa_update = spy
    try:
        _, summary = trainer.train()
    finally:
        tr.swa_update = orig
    assert summary["swa_snapshots"] == len(snaps) == 2
    mean = None
    for i, s in enumerate(snaps):
        leaves = k_taylor2.net_leaves(s["net"])
        n = torch.tensor(float(i + 1), device="cuda")  # a true division, as JAX's
        mean = leaves if mean is None else [a + (x - a) / n for a, x in zip(mean, leaves)]
    for a, b in zip(k_taylor2.net_leaves(trainer.swa_params["net"]), mean):
        assert torch.equal(a, b)


# -- the float64 modes (polish on the card) ----------------------------------

F64_RTOL = 1e-12


def _f64_net(layers, seed, device):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    return spec, init_mlp(spec, torch.Generator().manual_seed(seed), device)


def _hold_f64(got, plain):
    for i, (a, b) in enumerate(zip(got, plain)):
        assert a.dtype == torch.float64 and a.shape == b.shape, i
        assert float((a - b).abs().max()) <= F64_RTOL * float(b.abs().max()), i


@pytest.mark.parametrize("n", [1, 37, 10_456])
def test_f64_taylor2_kernels_match_plain_on_card(cuda_device, n):  # noqa: F811
    """K1's and K2's float64 modes at 8x20 against their float64 plain
    versions within 1e-12 of max|plain| per stream and leaf; two calls
    bit-equal; one launch of each a call."""
    spec, net = _f64_net((2,) + (20,) * 8 + (1,), 41, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=42)).to(cuda_device).double()
    rng = np.random.default_rng(43)
    cot = [torch.from_numpy(rng.standard_normal((n, 1))).to(cuda_device) for _ in range(4)]
    before = (k_taylor2.F64_LAUNCHES, k_taylor2.F64_BACKWARD_LAUNCHES, k_taylor2.LAUNCHES)
    got, again = k_taylor2.taylor2(spec, net, x), k_taylor2.taylor2(spec, net, x)
    grad = k_taylor2.taylor2_backward(spec, net, x, cot)
    grad2 = k_taylor2.taylor2_backward(spec, net, x, cot)
    torch.cuda.synchronize()
    assert (k_taylor2.F64_LAUNCHES, k_taylor2.F64_BACKWARD_LAUNCHES, k_taylor2.LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(grad, grad2)
    _hold_f64(got, mlp_taylor_2_reference(spec, net, x))
    _hold_f64(k_taylor2.split_grad(grad, k_taylor2.net_leaves(net)),
              k_taylor2.taylor2_backward_reference(spec, net, x, cot))


@pytest.mark.parametrize("n", [1, 100, 25_600])
def test_f64_mlp_kernels_match_plain_on_card(cuda_device, n):  # noqa: F811
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    spec, net = _f64_net((2,) + (20,) * 8 + (1,), 44, cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=45)).to(cuda_device).double()
    g = torch.from_numpy(np.random.default_rng(46).standard_normal((n, 1))).to(cuda_device)
    u, grad = k_mlp.mlp_forward(spec, net, x), k_mlp.mlp_backward(spec, net, x, g)
    assert torch.equal(grad, k_mlp.mlp_backward(spec, net, x, g))
    _hold_f64([u], [mlp_apply_reference(spec, net, x)])
    _hold_f64(k_taylor2.split_grad(grad, k_taylor2.net_leaves(net)),
              k_mlp.mlp_backward_reference(spec, net, x, g))


@pytest.mark.parametrize("count", [0, 7, 50])
def test_k10_f64_kernels_equal_their_plain_versions_on_card(cuda_device, count):  # noqa: F811
    """K10's float64 mode at 8x20's n with a history of 50 (the streamed
    layout): the direction and control kernels bit for bit against their
    float64 plain versions on a seeded state."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    n, m = 3_023, 50
    assert not k_lbfgs.cluster_plan(n, m, 8).resident
    b = k_lbfgs.seeded_state(n, m, count, 9, seed=count, device=cuda_device,
                             dtype=torch.float64)
    for kernel, plain in ((k_lbfgs.direction, k_lbfgs.direction_reference),
                          (k_lbfgs.control, k_lbfgs.control_reference)):
        if kernel is k_lbfgs.control:
            b.vec[k_lbfgs.GT] = torch.from_numpy(
                np.random.default_rng(count).standard_normal(n)).to(cuda_device)
            b.sf[k_lbfgs.F_PHI_T] = 0.5
        twin = b.clone()
        kernel(b)
        plain(twin)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(b.tensors(), twin.tensors()))


def test_polish_on_card(cuda_device, tmp_path):  # noqa: F811
    """polish of a short burgers_forward run at 8x20 on the card: the
    float64 modes launched, no host loop, no float32 kernel, the loss no
    higher; the CLI writes the polished checkpoint."""
    import json as _json

    from pinns_tpu_torch.cli import main as cli_main
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    sets = ["--set", "sampling.n_f=2000", "--set", "optimizer.kind=adam"]
    assert cli_main(["train", "--preset", "burgers_forward", *sets, "--epochs", "500",
                     "--out-dir", str(tmp_path)]) == 0
    ckpt = str(tmp_path / "burgers_forward_final.ckpt")
    before = (k_taylor2.F64_LAUNCHES, k_taylor2.F64_BACKWARD_LAUNCHES, k_mlp.F64_LAUNCHES,
              k_lbfgs.CONTROL_F64_LAUNCHES, host_lbfgs.HOST_SYNCS, k_taylor2.LAUNCHES,
              k_lbfgs.CONTROL_LAUNCHES)
    assert cli_main(["polish", "--preset", "burgers_forward", *sets, "--checkpoint", ckpt,
                     "--max-iters", "50"]) == 0
    after = (k_taylor2.F64_LAUNCHES, k_taylor2.F64_BACKWARD_LAUNCHES, k_mlp.F64_LAUNCHES,
             k_lbfgs.CONTROL_F64_LAUNCHES, host_lbfgs.HOST_SYNCS, k_taylor2.LAUNCHES,
             k_lbfgs.CONTROL_LAUNCHES)
    assert all(a > b for a, b in zip(after[:4], before[:4]))
    assert after[4] - before[4] == 1  # one launch of the solve's loop, one read
    assert after[6] == before[6]
    with open(ckpt + ".polished.ckpt.json") as fh:
        assert _json.load(fh) == {"polished": True}


@pytest.mark.parametrize("what", ["k1_tiled", "k2_wide", "k5_wide", "k7a", "adam"])
def test_f64_outside_the_modes_raises_on_card(cuda_device, what):  # noqa: F811
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1

    x = torch.zeros(8, 2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="later slice"):
        if what == "adam":
            from pinns_tpu_torch.config import override
            from pinns_tpu_torch.experiments import get_preset
            from pinns_tpu_torch.train.trainer import Trainer

            trainer = Trainer(override(get_preset("abgrall_admm"), {"model.dtype": "float64",
                                                                    "train.epochs": 2}))
            trainer.train()
        elif what == "k7a":
            spec, net = _f64_net((2, 20, 20, 3), 47, cuda_device)
            k_taylor1.taylor1(spec, net, x)
        else:
            spec, net = _f64_net((2, 40, 40, 1), 48, cuda_device)
            cot = [x[:, :1].contiguous()] * 4
            {"k1_tiled": lambda: k_taylor2.taylor2(spec, net, x),
             "k2_wide": lambda: k_taylor2.taylor2_backward(spec, net, x, cot),
             "k5_wide": lambda: k_mlp.mlp_forward(spec, net, x)}[what]()


# -- slice 6: K3's data-parallel modes and K11's row offset ------------------------

@pytest.mark.parametrize("layers,kind", [((2,) + (20,) * 8 + (1,), "admm"),
                                         ((2, 16, 16, 16, 1), "l1_sq_norm"),
                                         ((2, 40, 40, 40, 1), "admm"),
                                         ((2, 40, 40, 40, 1), "mean_sq")],
                         ids=["8x20-admm", "16-l1", "40-admm", "40-mean_sq"])
def test_dp_chunk_at_one_rank_equals_the_fused_chunk(cuda_device, layers, kind):  # noqa: F811
    """K3 under data parallelism at one rank (a shard with no process group:
    the three modes, no all-reduce): the graphed chunk and the per-epoch
    step equal the fused ones bit for bit, both designs, drawn and fed, and
    every epoch counts one reduce and one apply launch."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel.sharding import DataShard
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("abgrall_admm"), {
        "model.layers": layers, "loss.residual_kind": kind, "sampling.n_f": 200,
        "train.chunk": 8})
    plain = tr.Trainer(exp, device="cuda")
    dp = tr.Trainer(exp, device="cuda")
    dp.problem.shard = DataShard(rank=0, size=1)
    dp._adam_step = tr.make_step(dp.problem, dp.learning_rate)
    state = plain.init_state()
    for length in (1, 2, 7):
        before = (k_fused.DP_REDUCE_LAUNCHES, k_fused.DP_APPLY_LAUNCHES)
        _assert_same_chunk(dp._get_chunk("adam")(state, length),
                           plain._get_chunk("adam")(state, length))
        assert (k_fused.DP_REDUCE_LAUNCHES, k_fused.DP_APPLY_LAUNCHES) == (
            before[0] + length, before[1] + length)
    _assert_same_chunk(tr.run_chunk(dp._adam_step, state, 3),
                       tr.run_chunk(plain._adam_step, state, 3))
    feed = torch.from_numpy(np.stack([numpy_points(200, seed=s) for s in range(3)])).to(
        cuda_device)
    _assert_same_chunk(dp._get_chunk("adam")(state, 3, new_colloc=feed),
                       plain._get_chunk("adam")(state, 3, new_colloc=feed))


@pytest.mark.parametrize("layers,kind,ranks", [((2,) + (20,) * 8 + (1,), "admm", 2),
                                               ((2,) + (20,) * 8 + (1,), "l1_sq_norm", 4),
                                               ((2, 40, 40, 40, 1), "admm", 2),
                                               ((2, 40, 40, 40, 1), "l1_sq_norm", 4)],
                         ids=["8x20-admm-2", "8x20-l1-4", "40-admm-2", "40-l1-4"])
def test_dp_modes_match_their_plain_versions(cuda_device, layers, kind, ranks):  # noqa: F811
    """The reduce mode on each rank's rows against dp_reduce_reference
    (within 1e-4 of max|plain| a part: float32 partial sums in another
    order), their sums added as an all-reduce would, then the apply mode
    against dp_apply_reference bit for bit and the finalize mode's misfit
    against the plain misfit of the ranks' tail sums."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.opt.adam import bias_corrections

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    P = spec.n_params
    params = pack_params(init_mlp(spec, torch.Generator().manual_seed(5), cuda_device))
    mu, nu = 0.01 * torch.ones_like(params), 1e-4 * torch.ones_like(params)
    colloc = torch.from_numpy(numpy_points(400, seed=6)).to(cuda_device)
    x_data = torch.from_numpy(numpy_points(50, seed=7)).to(cuda_device)
    u_data = torch.sin(3.0 * x_data[:, :1]).contiguous()
    rng = np.random.default_rng(8)
    z = torch.from_numpy((0.1 * rng.standard_normal((400, 1))).astype(np.float32)).to(cuda_device)
    dual = torch.ones_like(z)
    admm = kind == "admm"
    cfg = dict(kind=kind, lam1=1.0, lam2=0.01, lr=1e-3, explicit_inner=False)
    n = 400 // ranks
    rank_sums = []
    for r in range(ranks):
        rows = slice(r * n, (r + 1) * n)
        sums = torch.zeros(2 * P + 3, dtype=torch.float64, device=cuda_device)
        dp = dict(sums=sums, n_f_all=400, row0=r * n, data_tiles=int(r == 0), mode="reduce")
        k_fused._epoch(spec, 1, params[None], mu[None], nu[None], 3, x_data, u_data,
                       colloc[rows][None], z[rows][None] if admm else None,
                       dual[rows][None] if admm else None, rho=10.0, seed=1234, epoch=4, dp=dp,
                       **cfg)
        want = k_fused.dp_reduce_reference(spec, params, x_data, u_data, colloc[rows],
                                           z[rows] if admm else None,
                                           dual[rows] if admm else None, kind=kind, lam1=1.0,
                                           lam2=0.01, rho=10.0, n_f_all=400,
                                           data_tiles=r == 0)
        for part in (slice(0, P), slice(P, 2 * P), slice(2 * P, 2 * P + 2)):
            err = float((sums[part] - want[part]).abs().max())
            assert err <= 1e-4 * float(want[part].abs().max()) + 1e-30, (r, part, err)
        rank_sums.append(sums)
    total = sum(rank_sums)
    misfit_sum = 0.0
    for r in range(ranks):
        rows = slice(r * n, (r + 1) * n)
        sums = total.clone()
        dp = dict(sums=sums, n_f_all=400, row0=r * n, data_tiles=int(r == 0), mode="apply")
        out = k_fused._epoch(spec, 1, params[None], mu[None], nu[None], 3, x_data, u_data,
                             colloc[rows][None], z[rows][None] if admm else None,
                             dual[rows][None] if admm else None, rho=10.0, seed=1234, epoch=4,
                             dp=dp, **cfg)
        bc1, bc2 = bias_corrections(3)
        p, m, v, metrics = k_fused.dp_apply_reference(total, params, mu, nu, kind=kind,
                                                      lr=1e-3, bc1=bc1, bc2=bc2, n_u=50,
                                                      n_f_all=400, lam1=1.0, lam2=0.01)
        for got, want in ((out["params"][0], p), (out["mu"][0], m), (out["nu"][0], v),
                          (out["metrics"][0][1:], metrics[1:].to(cuda_device))):
            assert torch.equal(got, want)
        misfit_sum += float(sums[2 * P + 2])
    misfit = torch.zeros(1, 7, device=cuda_device)
    sums = total.clone()
    sums[2 * P + 2] = misfit_sum
    k_fused._epoch(spec, 1, params[None], mu[None], nu[None], 3, x_data, u_data,
                   colloc[:n][None], z[:n][None] if admm else None,
                   dual[:n][None] if admm else None, rho=10.0, seed=1234, epoch=4,
                   metrics_out=misfit, dp=dict(sums=sums, n_f_all=400, row0=0, data_tiles=1,
                                               mode="finalize"), **cfg)
    want = k_fused.dp_finalize_reference(torch.tensor(misfit_sum, dtype=torch.float64), 400)
    assert float(misfit[0, 0]) == (float(want) if admm else 0.0)


@pytest.mark.parametrize("n,ranks", [(1_000, 4), (65_536, 2), (77, 7)])
def test_k11_row_offset_draws_the_whole_batch(cuda_device, n, ranks):  # noqa: F811
    """K11 at each rank's row offset: the draws stacked in rank order equal
    one launch of the whole batch bit for bit, and the plain version at
    those offsets."""
    from pinns_tpu_torch.ops.kernels import sampling
    from pinns_tpu_torch.train import schedule

    rows = schedule.schedule_rows(77, 0, 9, 1, 0.0, lambda e: ((-1.0, 0.0), (1.0, 0.99)))
    sched = schedule.to_device(rows, cuda_device)
    cursor = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    m = n // ranks
    parts = [sampling.philox_draw(sched, cursor, m, torch.float32, r * m) for r in range(ranks)]
    whole = sampling.philox_draw(sched, cursor, m * ranks)
    assert torch.equal(torch.cat(parts), whole)
    plain = sampling.philox_draw_reference(sched.cpu(), cursor.cpu(), m, torch.float32, m)
    assert torch.equal(parts[1].cpu(), plain)


def test_device_lbfgs_dp_at_one_rank_equals_the_solve(cuda_device):  # noqa: F811
    """K10's solve with K3's value-and-grad split into its data-parallel
    reduce and apply modes, at one rank (a shard with no process group):
    the same iterations, evaluations, x, f and g as the solve without a
    shard, bit for bit, from abgrall_admm's state after 200 Adam epochs; the
    sharded solve replays its 16-step graph (SolveReplay, by configuration),
    the other is one launch of its WHILE node."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k10
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.parallel.sharding import DataShard
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("abgrall_admm"), {"train.chunk": 200})
    trainer = tr.Trainer(exp, device="cuda")
    state, _ = trainer._get_chunk("adam")(trainer.init_state(), 200)
    x0, _ = ravel_tree(state.params)
    solo = k10.DeviceLBFGS(trainer.problem)
    dp_trainer = tr.Trainer(exp, device="cuda")
    dp_trainer.problem.shard = DataShard(rank=0, size=1)
    dp = k10.DeviceLBFGS(dp_trainer.problem)
    off = k10.net_offset(state.params)
    runs = [s.minimize(x0.detach(), off, state.colloc, state.admm, exp.loss.rho, max_iters=60)
            for s in (solo, dp)]
    a, b = runs
    assert (a.n_iters, a.n_evals, a.converged) == (b.n_iters, b.n_evals, b.converged)
    assert torch.equal(a.x, b.x) and torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    rho = float(np.float32(exp.loss.rho))
    assert type(solo.loops[rho]) is k10.SolveLoop and type(dp.loops[rho]) is k10.SolveReplay


def test_sweep_units_over_cards_equal_serial(cuda_device, tmp_path):  # noqa: F811
    """abgrall_admm sweep units dispatched over every card, one worker
    process a card: solo units (K9's graphed Adam chunks, then K10's graphed
    L-BFGS) and an ensemble unit (K8 in K9's graphs), every row ok, on the
    cards, more than one card used, and every summary equal to the same unit
    run serially in this process on cuda:0. Needs two cards or more."""
    import time

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.parallel import sweep

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("a sweep over cards needs two cards or more")
    base = override(get_preset("abgrall_admm"), {
        "train.epochs": 3020, "train.chunk": 1000, "train.log_every": 0,
        "optimizer.switch_epoch": 3000, "optimizer.lbfgs.max_iters": 20})
    grid = ([{"sampling.n_f": 1000 - 100 * k} for k in range(cards)]
            + [{"sampling.n_f": 960, "train.seed": s} for s in (1, 2)])
    t0 = time.perf_counter()
    serial = sweep.run_sweep(base, grid, devices=["cuda:0"], device="cuda:0")
    t1 = time.perf_counter()
    spread = sweep.run_sweep(base, grid, out_path=str(tmp_path / "rows.jsonl"), device="cuda")
    t2 = time.perf_counter()
    print(f"sweep of {len(grid)} configurations: serial on cuda:0 {t1 - t0:.2f} s, "
          f"over {cards} cards {t2 - t1:.2f} s")
    assert [r.status for r in serial] == ["ok"] * len(grid), [r.error for r in serial]
    assert [r.status for r in spread] == ["ok"] * len(grid), [r.error for r in spread]
    used = {r.device for r in spread}
    assert used <= {f"cuda:{k}" for k in range(cards)} and len(used) > 1, used
    for a, b in zip(serial, spread):
        assert a.overrides == b.overrides
        assert a.summary["rel_l2_u"] == b.summary["rel_l2_u"], (a.overrides, a.summary,
                                                                 b.summary)
        assert a.summary["epochs"] == b.summary["epochs"] == 3020


# -- K12, the FV time stepper of the data generators --------------------------
K12_CASES = {
    "periodic_viscous": dict(nx=257, nt=6, t_final=0.05, nu=1.9e-3, periodic=True),
    "outflow_inviscid": dict(nx=257, nt=6, t_final=0.3, nu=0.0, periodic=False),
    "t_offset": dict(nx=1025, nt=4, t_final=0.05, nu=4.9e-3, xlim=(0.0, 3.14159),
                     periodic=True, t_offset=0.012),
    "outflow_viscous_4096": dict(nx=4096, nt=3, t_final=0.002, nu=1e-3, periodic=False),
}


@pytest.mark.parametrize("case", sorted(K12_CASES))
def test_k12_burgers_equals_plain_on_card(cuda_device, case):  # noqa: F811
    """K12 against the plain version on the same card state, bit for bit,
    and two calls bit-equal."""
    from pinns_tpu_torch.data import generators as g
    from pinns_tpu_torch.ops.kernels import fv_solve

    kw = K12_CASES[case]
    p = g.burgers_plan(g.two_sin_ic, device=cuda_device, **kw)
    args = (p.q0, p.dx, p.dt, p.steps_per_snap, p.n_snap, kw["nu"], kw["periodic"],
            p.offset_steps)
    before = fv_solve.BURGERS_LAUNCHES
    got = fv_solve.burgers_trajectory(*args)
    again = fv_solve.burgers_trajectory(*args)
    want = fv_solve.burgers_trajectory_reference(*args)
    torch.cuda.synchronize()
    assert fv_solve.BURGERS_LAUNCHES == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert torch.equal(got, want), float((got - want).abs().max())


def test_k12_euler_equals_plain_on_card(cuda_device):  # noqa: F811
    from pinns_tpu_torch.data import generators as g
    from pinns_tpu_torch.ops.kernels import fv_solve

    p = g.euler_plan(nx=600, t_final=0.05, n_snapshots=4, device=cuda_device)
    args = (p.q0, p.dx, p.dt, p.steps_per_snap, p.n_snap)
    before = fv_solve.EULER_LAUNCHES
    got = fv_solve.euler_trajectory(*args)
    want = fv_solve.euler_trajectory_reference(*args)
    torch.cuda.synchronize()
    assert fv_solve.EULER_LAUNCHES == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, fv_solve.euler_trajectory(*args))
    assert torch.equal(got, want), float((got - want).abs().max())


def test_k12_refuses_what_it_does_not_take_on_card(cuda_device):  # noqa: F811
    from pinns_tpu_torch.ops.kernels import fv_solve

    limit = fv_solve.smem_limit(cuda_device.index or 0)
    n = fv_solve.max_cells(limit, True) + 1
    with pytest.raises(NotImplementedError, match="--device cpu"):
        fv_solve.euler_trajectory(torch.ones((n, 3), device=cuda_device), 1e-3, 1e-4, 1, 2)
    with pytest.raises(NotImplementedError, match="--device cpu"):
        fv_solve.burgers_trajectory(torch.ones(64, dtype=torch.float64, device=cuda_device),
                                    1e-2, 1e-3, 1, 2)
