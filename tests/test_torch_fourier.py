"""Port parity for the Fourier features (the rest of slice 2b-iii): the
frequency matrix, the embedding and its Taylor streams, the forward pass and
both Taylor recurrences with Fourier features (alone, with shock paths, and
shock paths alone on Taylor-2), one training step of a Burgers strong preset,
an Euler preset and a weak preset with them, and a JAX Fourier state
resumed, checkpointed and served by the port.

Inputs come from numpy seeds; JAX runs on the CPU, with small nets (3
layers, width 8), F = 4 features at sigma 3 (PARITY's setting) and K = 2
paths. Tolerances, each with its reason:
- ``fourier_matrix``: bit for bit (the same numpy draw);
- the embedding and its streams, the forward and Taylor streams: rtol 1e-5 /
  atol 1e-6 max|JAX| (float32 in another operation order), or the float64
  criterion (the port's error against float64 at most 4x JAX's plus 1e-6
  max|exact|) where sin and cos of |z| up to about 60 rad take the ulps in
  which the two libraries' float32 sin and cos differ, amplified by the
  chain through the tanh layers;
- losses rtol 1e-4; gradients rtol 1e-4 / atol 1e-5 max|g| per leaf, or the
  float64 criterion where a leaf's sum cancels; one Adam step's params to a
  tenth of the learning rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.models import mlp as jmlp
from pinns_tpu.ops import taylor as jtaylor
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu.train.evaluate import predict_fields as jpredict_fields
from pinns_tpu_torch import interop
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.models import mlp as tmlp
from pinns_tpu_torch.ops import taylor as ttaylor
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.serve import ServedModel, export_predict
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import LB, UB, numpy_params, numpy_points

CPU = torch.device("cpu")
SMALL = (2, 8, 8, 8, 1)
F, SIGMA, K = 4, 3.0, 2
N = 256
F64_FACTOR = 4.0
FEATURES = {"fourier": (F, 0), "fourier_paths": (F, K), "paths": (0, K)}


def specs(layers=SMALL, f=F, k=K, seed=0):
    kw = dict(layers=layers, lb=LB, ub=UB, fourier=jmlp.fourier_matrix(f, sigma=SIGMA, seed=seed)
              if f else (), n_paths=k, path_degree=2, path_sharpness=12.0)
    return jmlp.MLPSpec(**kw), tmlp.MLPSpec(**kw)


def feature_net(tspec, seed):
    """JAX-layout numpy params of the spec's widths (W_0 takes 2 + 2F + K
    inputs), the paths moved off their init."""
    net = numpy_params(tspec.widths, seed)
    if tspec.n_paths:
        rng = np.random.default_rng(seed + 100)
        k = tspec.n_paths
        c = (0.3 * rng.standard_normal((k, 3))).astype(np.float32)
        c[:, 0] = (2.0 * (np.arange(k) + 0.5) / k - 1.0).astype(np.float32)
        net[0]["path_c"] = c
        net[0]["path_a"] = (12.0 * (1.0 + 0.2 * rng.standard_normal(k))).astype(np.float32)
    return net


def _jnet(net):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def _close_or_f64(name, got, want, exact, rtol=1e-5, atol_rel=1e-6):
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - want) <= rtol * np.abs(want) + atol_rel * np.abs(want).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


def _f64(tspec, net):
    spec64 = dataclasses.replace(tspec, dtype=torch.float64)
    return spec64, [{k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in layer.items()}
                    for layer in net]


# -- the frequency matrix and the embedding ----------------------------------------

@pytest.mark.parametrize("n,in_dim,sigma,seed", [(16, 2, 3.0, 0), (4, 2, 1.0, 7), (1, 3, 10.0, 3)])
def test_fourier_matrix_is_jax_bit_for_bit(n, in_dim, sigma, seed):
    assert tmlp.fourier_matrix(n, in_dim, sigma, seed) == jmlp.fourier_matrix(n, in_dim, sigma,
                                                                              seed)


def test_frequencies_equal_jax_and_spec_counts():
    """2 pi B^T rounded as JAX rounds it (bit for bit), and the spec's widths
    and parameter count equal JAX's."""
    jspec, tspec = specs()
    np.testing.assert_array_equal(tmlp.fourier_frequencies(tspec),
                                  np.asarray(jmlp._fourier_b(jspec)))
    assert tspec.embed_dim == jspec.embed_dim == 2 + 2 * F + K
    assert tspec.n_params == jspec.n_params
    assert tspec.widths == (2 + 2 * F + K,) + SMALL[1:]
    jp = jmlp.init_mlp(jax.random.key(0), jspec)
    tp = tmlp.init_mlp(tspec, torch.Generator().manual_seed(0), CPU)
    assert tuple(tp[0]["W"].shape) == jp[0]["W"].shape


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_embedding_and_streams_match_jax(feature):
    f, k = FEATURES[feature]
    jspec, tspec = specs(f=f, k=k, seed=1)
    net = feature_net(tspec, 2)
    h = 2.0 * np.random.default_rng(3).uniform(size=(N, 2)).astype(np.float32) - 1.0
    h[:2] = [(-1.0, -1.0), (1.0, 1.0)]  # |z| at its largest
    tl0 = interop.params_from_jax(net, CPU)[0]
    jl0 = _jnet(net)[0]
    spec64, net64 = _f64(tspec, net)
    got = tmlp.embed_inputs(tspec, torch.from_numpy(h), tl0)
    want = jmlp.embed_inputs(jspec, jnp.asarray(h), jl0)
    exact = tmlp.embed_inputs(spec64, torch.from_numpy(h.astype(np.float64)), net64[0])
    _close_or_f64("embedding", got.numpy(), want, exact.numpy())
    streams = tmlp.embed_streams(tspec, torch.from_numpy(h), tl0)
    jstreams = jmlp.embed_streams(jspec, jnp.asarray(h), jl0)
    exact = tmlp.embed_streams(spec64, torch.from_numpy(h.astype(np.float64)), net64[0])
    for name, g, w, e in zip(("value", "x", "t", "xx"), streams, jstreams, exact):
        assert tuple(g.shape) == (N, tspec.embed_dim)
        _close_or_f64(name, g.numpy(), w, e.numpy())


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_forward_and_taylor_streams_match_jax(feature):
    """mlp_apply and mlp_taylor_2 (Fourier, Fourier + paths, paths) and
    mlp_taylor_1 through a Fourier net."""
    f, k = FEATURES[feature]
    jspec, tspec = specs(f=f, k=k, seed=4)
    net = feature_net(tspec, 5)
    x = numpy_points(N, 6)
    jn, tn = _jnet(net), interop.params_from_jax(net, CPU)
    spec64, net64 = _f64(tspec, net)
    xt, x64 = torch.from_numpy(x), torch.from_numpy(x.astype(np.float64))
    _close_or_f64("u", tmlp.mlp_apply(tspec, tn, xt).numpy(),
                  jmlp.mlp_apply(jspec, jn, jnp.asarray(x)),
                  tmlp.mlp_apply(spec64, net64, x64).numpy())
    for name, g, w, e in zip(("u", "u_x", "u_t", "u_xx"), ttaylor.mlp_taylor_2(tspec, tn, xt),
                             jtaylor.mlp_taylor_2(jspec, jn, jnp.asarray(x)),
                             ttaylor.mlp_taylor_2(spec64, net64, x64)):
        _close_or_f64(name, g.numpy(), w, e.numpy())
    if feature == "paths":
        return
    for name, g, w, e in zip(("u", "u_x", "u_t"), ttaylor.mlp_taylor_1(tspec, tn, xt),
                             jtaylor.mlp_taylor_1(jspec, jn, jnp.asarray(x)),
                             ttaylor.mlp_taylor_1(spec64, net64, x64)):
        _close_or_f64(name, g.numpy(), w, e.numpy())


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_taylor2_backward_reference_matches_autograd(feature):
    """K2's plain reverse mode with Fourier and path features (the xx
    stream's phi_xx adjoint included) against autograd in float64: 1e-10 of
    each leaf's max."""
    f, k = FEATURES[feature]
    _, tspec = specs(f=f, k=k, seed=7)
    spec64, net64 = _f64(tspec, feature_net(tspec, 8))
    x = torch.from_numpy(numpy_points(64, 9).astype(np.float64))
    cot = [torch.from_numpy(np.random.default_rng(10 + i).standard_normal((64, 1)))
           for i in range(4)]
    leaves = [t.clone().requires_grad_(True) for t in k_taylor2.net_leaves(net64)]
    out = ttaylor.mlp_taylor_2(spec64, k_taylor2.net_from_leaves(leaves, k), x)
    auto = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(out, cot)), leaves)
    ref = k_taylor2.taylor2_backward_reference(spec64, net64, x, cot)
    assert len(ref) == len(auto)
    for i, (a, r) in enumerate(zip(auto, ref)):
        torch.testing.assert_close(r.reshape(a.shape), a, rtol=0,
                                   atol=1e-10 * float(a.abs().max()) + 1e-300,
                                   msg=f"leaf {i}")


def test_plans_take_the_feature_widths():
    """K1 takes the tiled design, K7a and K5 the wide one for any net with
    features, and each plan's input rows hold 2 + 2F + K columns and the
    indicator."""
    from pinns_tpu_torch.ops.kernels import mlp_forward as k5
    from pinns_tpu_torch.ops.kernels import taylor1 as k7a

    _, tspec = specs(layers=(2, 20, 20, 1), f=F, k=0)
    assert k_taylor2.launch_config(tspec.widths).design == "tiled"
    assert k_taylor2.launch_config((2, 20, 20, 1)).design == "narrow"
    assert k7a.default_design(tspec.widths) == "wide"
    assert k5.design(tspec.widths) == "wide"
    plan = k_taylor2.backward_plan(tspec.widths, 300)
    assert plan.h0 == 4 * plan.n_pad * ((2 + 2 * F + 4) // 4 * 4) and plan.psums == 0
    _, pspec = specs(layers=(2, 20, 20, 1), f=F, k=K)
    plan = k_taylor2.backward_plan(pspec.widths, 300, path_params=pspec.n_path_params)
    assert plan.psums == 2 * (plan.n_pad // k_taylor2.GEMM_TILE) * pspec.n_path_params
    assert k7a.taylor1_plan(tspec.widths, 300, backward=True).launches == 2 * 3 + 2
    with pytest.raises(ValueError, match="Fourier features"):
        k_taylor2.check_paths("taylor2", specs(f=k_taylor2.MAX_FOURIER + 1, k=0)[1])


# -- training steps ----------------------------------------------------------------

STEP_CASES = {
    "burgers_forward": {"model.layers": (2, 8, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 32},
    "euler_admm": {"model.layers": (2, 8, 8, 8, 3), "sampling.n_f": 64, "data.n_u": 32},
    "twosin_weak": {"model.layers": (2, 8, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 32},
}


def _assert_grad(name, got, want, exact):
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


def jax_state_tree(jstate):
    tree = {"params": jstate.params, "count": 0, "mu": jstate.opt_state[0].mu,
            "nu": jstate.opt_state[0].nu, "colloc": jstate.colloc, "epoch": 0}
    if jstate.admm is not None:
        tree["z"], tree["dual"] = jstate.admm.z, jstate.admm.dual
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("preset", sorted(STEP_CASES))
def test_fourier_preset_loss_grad_and_step_match_jax(preset):
    """The preset at a small net with ``model.n_fourier=4`` from JAX's
    initial state: the loss terms and every leaf's gradient, then one Adam
    step's params."""
    upd = dict(STEP_CASES[preset], **{"model.n_fourier": F})
    jexp = joverride(JPRESETS[preset], upd)
    jp = jtrainer.build_problem(jexp)
    tp = ttrainer.build_problem(override(get_preset(preset), upd), "cpu")
    assert tp.spec.fourier == jp.spec.fourier and tp.spec.widths[0] == jp.spec.embed_dim
    np.testing.assert_array_equal(tp.x_data.numpy(), np.asarray(jp.x_data))
    jtr = jtrainer.Trainer(jexp, problem=jp)
    jstate = jtr.init_state()
    (_, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jstate.params, jstate.colloc, jstate.admm, None)
    state = interop.train_state_from_jax(jax_state_tree(jstate), CPU, key=1234)
    grads, auxs = {}, {}
    for dtype in (torch.float32, torch.float64):
        prob = tp if dtype == torch.float32 else ttrainer.build_problem(
            override(get_preset(preset), dict(upd, **{"model.dtype": "float64"})), "cpu")
        cast = lambda t: t.to(dtype).clone()  # noqa: E731
        params = ttrainer.tree_map(lambda t: cast(t).requires_grad_(True), state.params)
        admm = None if state.admm is None else ttrainer.ADMMState(
            z=ttrainer.tree_map(cast, state.admm.z), dual=ttrainer.tree_map(cast, state.admm.dual))
        loss, aux = ttrainer.make_loss_fn(prob)(params, state.colloc.to(dtype), admm)
        leaves = k_taylor2.net_leaves(params["net"])
        grads[dtype] = [g.detach().numpy() for g in torch.autograd.grad(loss, leaves)]
        auxs[dtype] = aux
    for k in ("loss", "data_term", "res_term"):
        np.testing.assert_allclose(float(auxs[torch.float32][k].detach()), float(jaux[k]),
                                   rtol=1e-4, err_msg=k)
    layers = len(tp.spec.layers) - 1
    jleaves = [jgrad["net"][i][k] for i in range(layers) for k in ("W", "b")]
    for i, (g, w, e) in enumerate(zip(grads[torch.float32], jleaves, grads[torch.float64])):
        _assert_grad(f"leaf {i}", g.ravel(), np.asarray(w).ravel(), e.ravel())
    jstate1, _ = jax.jit(jtrainer.make_adam_step(jp, jtr.optimizer))(jstate)
    step = ttrainer.make_adam_step(tp, ttrainer.learning_rate_schedule(tp.exp.optimizer))
    state1, _ = step(state, new_colloc=torch.from_numpy(np.array(jstate1.colloc)))
    lr = tp.exp.optimizer.learning_rate
    want = [jstate1.params["net"][i][k] for i in range(layers) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(k_taylor2.net_leaves(state1.params["net"]), want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0.1 * lr,
                                   err_msg=f"leaf {i}")


def test_fourier_trains_from_the_cli(tmp_path):
    """``train --set model.n_fourier=4`` on a tiny burgers_forward through the
    port's CLI: the checkpoint's W_0 has 2 + 2F rows and the metrics are
    finite."""
    from pinns_tpu_torch import cli

    out = tmp_path / "run"
    rc = cli.main(["train", "--preset", "burgers_forward", "--device", "cpu", "--epochs", "3",
                   "--out-dir", str(out), "--set", "model.n_fourier=4",
                   "--set", "model.layers=(2, 8, 8, 1)", "--set", "sampling.n_f=64",
                   "--set", "data.n_u=32", "--set", "train.chunk=3"])
    assert rc in (0, None)
    state = ckpt_io.load_checkpoint(str(out / "burgers_forward_final.ckpt"), "cpu")
    assert tuple(state.params["net"][0]["W"].shape) == (2 + 2 * F, 8)
    assert all(torch.isfinite(t).all() for t in k_taylor2.net_leaves(state.params["net"]))


# -- checkpoints and serving -------------------------------------------------------

def test_jax_fourier_state_resumes_and_serves(tmp_path):
    """A JAX Fourier state (burgers_forward at a small net, two JAX steps)
    converted, checkpointed and resumed by the port's trainer bit for bit;
    the params file keeps B; the served model equals JAX's predict_fields
    (TOL of the affine net's u and f, or the float64 criterion)."""
    upd = dict(STEP_CASES["burgers_forward"], **{"model.n_fourier": F})
    jexp = joverride(JPRESETS["burgers_forward"], upd)
    jtr = jtrainer.Trainer(jexp)
    jstate = jtr.init_state()
    jstep = jax.jit(jtrainer.make_adam_step(jtr.problem, jtr.optimizer))
    for _ in range(2):
        jstate, _ = jstep(jstate)
    tree = jax_state_tree(jstate)
    tree["count"], tree["epoch"] = 2, 2
    trainer = ttrainer.Trainer(override(get_preset("burgers_forward"),
                                        dict(upd, **{"train.out_dir": str(tmp_path)})),
                               device="cpu")
    state = interop.train_state_from_jax(tree, CPU, key=1234)
    path = trainer.save_checkpoint(state, tag="jax")
    resumed = trainer.load_checkpoint(path)
    for a, b in zip(k_taylor2.net_leaves(state.params["net"]),
                    k_taylor2.net_leaves(resumed.params["net"])):
        assert torch.equal(a, b)
    run = ttrainer.make_adam_step(trainer.problem, trainer.learning_rate)
    s1, _ = run(state)
    s2, _ = run(resumed)
    for a, b in zip(k_taylor2.net_leaves(s1.params["net"]), k_taylor2.net_leaves(s2.params["net"])):
        assert torch.equal(a, b)
    spec = trainer.problem.spec
    params_np = interop.params_to_numpy(state.params["net"])
    npz = interop.save_params_npz(str(tmp_path / "p.npz"), spec, params_np, 1.0, 0.01 / np.pi)
    loaded = interop.load_params_npz(npz)
    assert loaded["spec"] == spec
    art = export_predict(spec, params_np, str(tmp_path / "art"), 1.0, 0.01 / np.pi,
                         experiment="burgers_forward")
    served = ServedModel(art, device="cpu")
    assert served.spec.fourier == spec.fourier
    x = numpy_points(200, 11)
    got = served.predict(x)
    want = jpredict_fields(jtr.problem, jstate.params, jnp.asarray(x))
    spec64 = dataclasses.replace(spec, dtype=torch.float64)
    net64 = [{k: v.double() for k, v in layer.items()} for layer in state.params["net"]]
    exact = ttaylor.mlp_taylor_2(spec64, net64, torch.from_numpy(x.astype(np.float64)))
    lam1, lam2 = (float(np.asarray(jstate.params["coeffs"][c])[0]) for c in ("lambda1",
                                                                           "lambda2"))
    f64 = exact[2] + lam1 * exact[0] * exact[1] - lam2 * exact[3]
    _close_or_f64("u", got["u"], want["u"], exact[0].numpy())
    _close_or_f64("f", got["f"], want["f"], f64.numpy(), atol_rel=1e-5)
