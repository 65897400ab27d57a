"""The port on the card: the fused Taylor-2 kernel (K1) and its backward
(K2), the fused MLP forward and its backward (K5), the served slice, the
fused Adam-epoch kernel (K3), and the trainer with its generic Adam step and
L-BFGS phase over the kernels.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda``, and skips
where ``torch.cuda.is_available()`` is False. The file imports no jax (the
GPU machine has none), so it also runs without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

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


@pytest.mark.parametrize("kind,explicit_inner", [("admm", False), ("admm", True), ("mean_sq", False),
                                                 ("l2_sq_norm", False), ("l1_sq_norm", False)])
def test_fused_step_matches_its_reference_on_card(cuda_device, kind, explicit_inner):  # noqa: F811
    """The CUDA step's loss and gradient against the hand-written reverse mode
    in plain PyTorch on the same card, and its Adam stage and ADMM tail
    against the plain functions fed the kernel's own gradient and params."""
    from pinns_tpu_torch.losses.admm import ADMMState, admm_misfit, admm_update
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.opt.adam import AdamState, adam_update

    layers = (2, 16, 16, 16, 1)
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    net = init_mlp(spec, torch.Generator().manual_seed(3), cuda_device)
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    colloc, x_data = t(numpy_points(77, seed=6)), t(numpy_points(13, seed=7))
    u_data = t(rng.standard_normal((13, 1)))
    z = t(0.1 * rng.standard_normal((77, 1))) if kind == "admm" else None
    dual = t(1 + 0.1 * rng.standard_normal((77, 1))) if kind == "admm" else None
    flat = pack_params(net)
    mu, nu = 0.01 * torch.ones_like(flat), 1e-4 * torch.ones_like(flat)
    new = t(numpy_points(77, seed=8))
    cfg = dict(kind=kind, lam1=0.9, lam2=0.01, rho=10.0, lr=1e-3, explicit_inner=explicit_inner)
    before = k_fused.LAUNCHES
    r = k_fused.fused_adam_step(spec, flat, mu, nu, 4, x_data, u_data, colloc, z, dual, seed=9,
                                epoch=5, new_colloc=new, want_grad=True, **cfg)
    torch.cuda.synchronize()
    assert k_fused.LAUNCHES == before + 1
    loss, data_term, res_term, grads = k_fused.loss_and_grad_reference(
        spec, net, x_data, u_data, colloc, z, dual, kind=kind, lam1=0.9, lam2=0.01, rho=10.0,
        explicit_inner=explicit_inner)
    got = r["grad"].cpu().numpy()
    off = 0
    for g in grads:
        w = g.reshape(-1).cpu().numpy()
        np.testing.assert_allclose(got[off:off + w.size], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
        off += w.size
    m = r["metrics"].cpu().numpy()  # trainer.METRIC_KEYS order
    np.testing.assert_allclose(m[[5, 1, 6]], [float(loss), float(data_term), float(res_term)],
                               rtol=1e-4)
    upd, adam = adam_update(r["grad"], AdamState(4, mu, nu), 1e-3)
    np.testing.assert_allclose(r["params"].cpu().numpy(), (flat + upd).cpu().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(r["colloc"], new)
    if kind == "admm":
        uu, ux, ut, uxx = mlp_taylor_2_reference(
            spec, k_fused.unpack_params(r["params"], layers), new)
        f = ut + 0.9 * uu * ux - 0.01 * uxx
        want = admm_update(f, ADMMState(z, dual), 10.0, 77)
        np.testing.assert_allclose(r["z"].cpu().numpy(), want.z.cpu().numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want.z.abs().max()))
        np.testing.assert_allclose(m[0], float(admm_misfit(f, want)), rtol=1e-4, atol=1e-7)


def test_trainer_on_card_runs_the_fused_step(cuda_device):  # noqa: F811
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {"train.epochs": 30, "train.chunk": 10,
                                                "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    before = k_fused.LAUNCHES
    state, summary = trainer.train()
    assert k_fused.LAUNCHES == before + 30 and state.epoch == 30
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
                                      ((2, 64, 1), 3)])
def test_mlp_forward_kernels_match_plain_on_card(cuda_device, layers, n):  # noqa: F811
    """K5 forward against mlp_apply_reference, K5 backward against the
    plain backward, both judged against float64; two backward calls agree bit
    for bit."""
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
                                      ((2, 64, 1), 3)])
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


def test_hybrid_trainer_on_card(cuda_device):  # noqa: F811
    """abgrall_admm through the switch on the card: Adam epochs on K3, then
    L-BFGS outer epochs over K5/K1/K2; nothing raises."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {
        "train.epochs": 22, "train.chunk": 10, "train.log_every": 0,
        "optimizer.switch_epoch": 20, "optimizer.lbfgs.max_iters": 20})
    k3, k5, k2 = k_fused.LAUNCHES, k_mlp.BACKWARD_LAUNCHES, k_taylor2.BACKWARD_LAUNCHES
    state, summary = Trainer(exp, device="cuda").train()
    assert k_fused.LAUNCHES == k3 + 20 and state.epoch == 22
    assert k_mlp.BACKWARD_LAUNCHES > k5 and k_taylor2.BACKWARD_LAUNCHES > k2
    assert np.isfinite(summary["rel_l2_u"])
