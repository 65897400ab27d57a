"""Port parity for the shock-path features and the mixed formulation (slice
2b-ii: ``euler_weak`` and ``euler_weak_fast``): the path streams and the
embedding, the forward pass and both Taylor recurrences through a path net,
the paths' backward algorithm (the one K7a and K5 run), the mixed
formulation's residuals, a reduced ``euler_weak_fast`` loss and step, the
interop round trip of a path net, and the refusals of what the slice leaves.

Inputs come from numpy seeds; JAX runs on the CPU. Tolerances, each with its
reason:
- the path streams and the embedding: rtol 1e-5 / atol 1e-6 max|JAX|
  (float32 in another operation order), or the float64 criterion (the
  port's error against float64 at most 4x JAX's plus 1e-6 max|exact|) where
  1 - phi^2 of a saturated tanh cancels;
- the forward and Taylor streams: ``torch_port_util.TOL`` (as the affine
  net's);
- the backward algorithms against autograd in float64: 1e-10 of each leaf's
  max;
- residuals, losses rtol 1e-4; gradients rtol 1e-4 / atol 1e-5 max|g| per
  leaf (``path_c`` and ``path_a`` included), or the float64 criterion where
  a leaf's sum cancels.
"""

import dataclasses
import math

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
from pinns_tpu_torch import interop
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.models import mlp as tmlp
from pinns_tpu_torch.ops import taylor as ttaylor
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels import mlp_forward as k5
from pinns_tpu_torch.ops.kernels import taylor1 as k7a
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import LB, UB, assert_close, numpy_params, numpy_points

CPU = torch.device("cpu")
TRUNK = (2, 16, 16, 3)  # a 2x16 Euler trunk
K, DEGREE, SHARPNESS = 2, 2, 12.0
N = 256
F64_FACTOR = 4.0


def path_net(layers=TRUNK, k=K, degree=DEGREE, seed=0):
    """JAX-layout numpy params of a path net: W_0 takes 2 + k inputs; the
    paths moved off their init (curved, tilted, unequal sharpness)."""
    rng = np.random.default_rng(seed)
    net = numpy_params((2 + k,) + tuple(layers[1:]), seed)
    c = (0.3 * rng.standard_normal((k, degree + 1))).astype(np.float32)
    c[:, 0] = (2.0 * (np.arange(k) + 0.5) / k - 1.0).astype(np.float32)
    net[0]["path_c"] = c
    net[0]["path_a"] = (SHARPNESS * (1.0 + 0.2 * rng.standard_normal(k))).astype(np.float32)
    return net


def specs(layers=TRUNK, k=K, degree=DEGREE):
    kw = dict(layers=layers, lb=LB, ub=UB, n_paths=k, path_degree=degree,
              path_sharpness=SHARPNESS)
    return jmlp.MLPSpec(**kw), tmlp.MLPSpec(**kw)


def _jnet(net):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def _close(name, got, want, rtol=1e-5, atol_rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=name)


def _close_or_f64(name, got, want, exact, rtol=1e-5, atol_rel=1e-6):
    """rtol / atol_rel max|JAX| against JAX, or the float64 criterion: the
    port's error against float64 at most 4x JAX's plus 1e-6 max|exact|
    (where a stream cancels: 1 - phi^2 of a saturated tanh takes the ulp in
    which the two libraries' float32 tanh differ)."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - want) <= rtol * np.abs(want) + atol_rel * np.abs(want).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


def _leaves64(net):
    """The port's leaves in kernel order (``net_leaves``), float64, with grad."""
    params = interop.params_from_jax(net, CPU)
    params = [{k: v.double().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    return params, k_taylor2.net_leaves(params)


# -- the spec, the init and the streams ------------------------------------------

def test_spec_counts_and_init_match_jax():
    """embed_dim, n_params and the deterministic initial paths equal JAX's."""
    jspec, tspec = specs()
    assert tspec.embed_dim == jspec.embed_dim == 2 + K
    assert tspec.n_params == jspec.n_params
    assert tspec.widths == (2 + K,) + TRUNK[1:]
    jp = jmlp.init_mlp(jax.random.key(0), jspec)
    tp = tmlp.init_mlp(tspec, torch.Generator().manual_seed(0), CPU)
    assert tp[0]["W"].shape == jp[0]["W"].shape
    for key in tmlp.PATH_KEYS:
        np.testing.assert_array_equal(tp[0][key].numpy(), np.asarray(jp[0][key]), err_msg=key)
    assert sum(t.numel() for t in k_taylor2.net_leaves(tp)) == tspec.n_params


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_path_streams_and_embedding_match_jax(degree):
    jspec, tspec = specs(degree=degree)
    net = path_net(degree=degree, seed=degree)
    h = 2.0 * np.random.default_rng(1).uniform(size=(N, 2)).astype(np.float32) - 1.0
    jl0 = _jnet(net)[0]
    tl0 = interop.params_from_jax(net, CPU)[0]
    spec64 = dataclasses.replace(tspec, dtype=torch.float64)
    l064 = {k: v.double() for k, v in tl0.items()}
    h64 = torch.from_numpy(h).double()
    want = jmlp._path_streams(jspec, jl0, jnp.asarray(h))
    got = tmlp.path_streams(tspec, tl0, torch.from_numpy(h))
    exact = tmlp.path_streams(spec64, l064, h64)
    for name, g, w, e in zip(("phi", "phi_x", "phi_t", "phi_xx"), got, want, exact):
        _close_or_f64(name, g.numpy(), w, e.numpy())
    _close_or_f64("embed_inputs", tmlp.embed_inputs(tspec, torch.from_numpy(h), tl0).numpy(),
                  jmlp.embed_inputs(jspec, jnp.asarray(h), jl0),
                  tmlp.embed_inputs(spec64, h64, l064).numpy())
    for name, g, w, e in zip(("h", "dx", "dt", "dxx"),
                             tmlp.embed_streams(tspec, torch.from_numpy(h), tl0),
                             jmlp.embed_streams(jspec, jnp.asarray(h), jl0),
                             tmlp.embed_streams(spec64, h64, l064)):
        _close_or_f64(name, g.numpy(), w, e.numpy())


def test_forward_and_taylor_streams_match_jax():
    """mlp_apply, mlp_taylor_1 and mlp_taylor_2 through a path net."""
    jspec, tspec = specs()
    net = path_net(seed=3)
    x = numpy_points(N, 4)
    jnet, tnet = _jnet(net), interop.params_from_jax(net, CPU)
    xt = torch.from_numpy(x)
    y = tmlp.mlp_apply(tspec, tnet, xt)
    want = jmlp.mlp_apply(jspec, jnet, jnp.asarray(x))
    assert_close("u", y.numpy(), want)
    for name, g, w in zip(("u", "u_x", "u_t"), ttaylor.mlp_taylor_1(tspec, tnet, xt),
                          jtaylor.mlp_taylor_1(jspec, jnet, jnp.asarray(x))):
        assert_close(name, g.numpy(), w)
    jspec1 = dataclasses.replace(jspec, layers=TRUNK[:-1] + (1,))
    tspec1 = dataclasses.replace(tspec, layers=TRUNK[:-1] + (1,))
    net1 = [dict(layer) for layer in net]
    net1[-1] = {"W": net[-1]["W"][:, :1], "b": net[-1]["b"][:, :1]}
    for name, g, w in zip(("u", "u_x", "u_t", "u_xx"),
                          ttaylor.mlp_taylor_2(tspec1, interop.params_from_jax(net1, CPU), xt),
                          jtaylor.mlp_taylor_2(jspec1, _jnet(net1), jnp.asarray(x))):
        assert_close(name, g.numpy(), w)


def test_path_backward_matches_autograd_and_jax():
    """The paths' chain rule (csrc/paths.cuh, path_backward_reference)
    against autograd through path_streams in float64, and against jax.grad
    through JAX's _path_streams."""
    jspec, tspec = specs()
    tspec64 = dataclasses.replace(tspec, dtype=torch.float64)
    net = path_net(seed=5)
    rng = np.random.default_rng(6)
    h = 2.0 * rng.uniform(size=(N, 2)) - 1.0
    cots = [rng.standard_normal((N, K)) for _ in range(3)]
    l0 = {k: torch.tensor(net[0][k], dtype=torch.float64, requires_grad=True)
          for k in tmlp.PATH_KEYS}
    ht = torch.from_numpy(h)
    outs = tmlp.path_streams(tspec64, l0, ht)[:3]
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    want = torch.autograd.grad(total, [l0["path_c"], l0["path_a"]])
    got = tmlp.path_backward_reference(tspec64, l0, ht, *(torch.from_numpy(c) for c in cots))
    for name, g, w in zip(tmlp.PATH_KEYS, got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(w.abs().max()), err_msg=name)

    def jloss(l0j):
        o = jmlp._path_streams(jspec, l0j, jnp.asarray(h, jnp.float32))[:3]
        return sum(jnp.sum(a * jnp.asarray(c, jnp.float32)) for a, c in zip(o, cots))

    jg = jax.grad(jloss)({k: jnp.asarray(net[0][k]) for k in tmlp.PATH_KEYS})
    for name, g in zip(tmlp.PATH_KEYS, got):
        _close(name, g.detach().numpy(), jg[name], rtol=1e-4, atol_rel=1e-5)


@pytest.mark.parametrize("kernel", ["k7a", "k5"])
def test_kernel_backward_references_match_autograd(kernel):
    """K7a's and K5's backward algorithms with paths (every trunk leaf, then
    path_c and path_a) against autograd through the plain forward, float64."""
    _, tspec = specs()
    spec64 = dataclasses.replace(tspec, dtype=torch.float64)
    params, leaves = _leaves64(path_net(seed=7))
    x = torch.from_numpy(numpy_points(N, 8)).double()
    rng = np.random.default_rng(9)
    if kernel == "k7a":
        cots = [torch.from_numpy(rng.standard_normal((N, 3))) for _ in range(3)]
        outs = ttaylor.mlp_taylor_1_reference(spec64, params, x)
        got = k7a.taylor1_backward_reference(spec64, params, x, cots)
    else:
        cots = [torch.from_numpy(rng.standard_normal((N, 3)))]
        outs = (tmlp.mlp_apply_reference(spec64, params, x),)
        got = k5.mlp_backward_reference(spec64, params, x, cots[0])
    total = sum((o * c).sum() for o, c in zip(outs, cots))
    want = torch.autograd.grad(total, leaves)
    assert len(got) == len(want) == 2 * (len(TRUNK) - 1) + 2
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(w.abs().max()), err_msg=f"leaf {i}")


def test_module_holds_the_paths():
    _, tspec = specs()
    net = interop.params_from_jax(path_net(seed=10), CPU)
    m = tmlp.MLP(tspec, device=CPU, params=net)
    names = {n for n, _ in m.named_parameters()}
    assert {"path_c", "path_a"} <= names
    assert sum(p.numel() for p in m.parameters()) == tspec.n_params
    x = torch.from_numpy(numpy_points(16, 11))
    torch.testing.assert_close(m(x), tmlp.mlp_apply(tspec, net, x), rtol=0, atol=0)


# -- the mixed formulation, the reduced preset -------------------------------------

SMALL_UPDATES = {"model.layers": TRUNK, "sampling.n_f": 64, "data.n_u": 64}


def _problems(preset, updates):
    jp = jtrainer.build_problem(joverride(JPRESETS[preset], updates))
    tp = ttrainer.build_problem(override(get_preset(preset), updates), "cpu")
    return jp, tp


def _colloc(tp, n, seed):
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(tp.lb[i], tp.ub[i], n) for i in range(2)], axis=1)
    c = c.astype(np.float32)
    c[:4] = [(tp.lb[0], tp.lb[1]), (tp.ub[0], tp.ub[1]), (tp.lb[0], tp.ub[1]),
             (tp.ub[0], tp.lb[1])]
    return c


@pytest.mark.parametrize("strong", [(0,), (0, 2), ()], ids=["mass", "mass-energy", "weak"])
def test_mixed_formulation_residuals_match_jax(strong):
    """Each equation: the strong residual where selected, the cell mean
    elsewhere, against JAX's flux_residuals_and_entropy."""
    upd = dict(SMALL_UPDATES, **{"loss.strong_equations": strong})
    jp, tp = _problems("euler_weak_fast", upd)
    assert tp.spec.n_paths == jp.spec.n_paths == 2
    net = path_net(seed=12)
    c = _colloc(tp, 64, 13)
    coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.full(1, 1e-3, np.float32)}
    jrs, _ = jp.flux_residuals_and_entropy(
        {"net": _jnet(net), "coeffs": {k: jnp.asarray(v) for k, v in coeffs.items()}},
        jnp.asarray(c), False)
    trs, _ = tp.flux_residuals_and_entropy(
        {"net": interop.params_from_jax(net, CPU),
         "coeffs": {k: torch.from_numpy(v) for k, v in coeffs.items()}}, torch.from_numpy(c))
    strong_f = tp.residuals({"net": interop.params_from_jax(net, CPU), "coeffs": None},
                            torch.from_numpy(c))
    for i, (g, w) in enumerate(zip(trs, jrs)):
        _close(f"r{i + 1}", g.numpy(), w, rtol=1e-4, atol_rel=1e-5)
        if i in strong:
            torch.testing.assert_close(g, strong_f[i], rtol=0, atol=0)


def test_mixed_formulation_refuses_what_jax_refuses():
    _, tp = _problems("euler_weak_fast", dict(SMALL_UPDATES, **{"loss.strong_equations": (3,)}))
    params = {"net": interop.params_from_jax(path_net(seed=14), CPU),
              "coeffs": {"lambda1": torch.ones(1), "lambda2": torch.full((1,), 1e-3)}}
    with pytest.raises(ValueError, match="indices"):
        tp.flux_residuals_and_entropy(params, torch.zeros(4, 2))
    burgers = ttrainer.build_problem(override(get_preset("twosin_weak"), {
        "loss.strong_equations": (0,), "model.layers": (2, 8, 1)}), "cpu")
    with pytest.raises(ValueError, match="Euler mixed formulation"):
        burgers.flux_residuals_and_entropy(
            {"net": interop.params_from_jax(numpy_params((2, 8, 1), 1), CPU),
             "coeffs": params["coeffs"]}, torch.zeros(4, 2))


def _assert_grad(name, got, want, exact):
    """rtol 1e-4 / atol 1e-5 max|JAX|, or the float64 criterion where the
    leaf's sum cancels."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


@pytest.mark.parametrize("preset", ["euler_weak_fast", "euler_weak"])
def test_reduced_preset_loss_grad_and_step_match_jax(preset):
    """The preset at a 2x16 trunk and N_f 64 from JAX's initial state: the
    loss terms and every leaf's gradient (path_c and path_a included), then
    one Adam step's params."""
    jp, tp = _problems(preset, SMALL_UPDATES)
    np.testing.assert_array_equal(tp.x_data.numpy(), np.asarray(jp.x_data))
    jtr = jtrainer.Trainer(joverride(JPRESETS[preset], SMALL_UPDATES), problem=jp)
    jstate = jtr.init_state()
    jparams = jstate.params
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jparams, jstate.colloc, None, None)
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": jparams, "count": 0, "mu": jstate.opt_state[0].mu,
        "nu": jstate.opt_state[0].nu, "colloc": jstate.colloc, "epoch": 0})
    state = interop.train_state_from_jax(tree, CPU, key=1234)
    assert set(state.params["net"][0]) == {"W", "b", "path_c", "path_a"}
    grads, losses = {}, {}
    for dtype in (torch.float32, torch.float64):
        prob = tp if dtype == torch.float32 else ttrainer.build_problem(
            override(get_preset(preset), dict(SMALL_UPDATES, **{"model.dtype": "float64"})),
            "cpu")
        params = ttrainer.tree_map(lambda t: t.to(dtype).clone().requires_grad_(True),
                                   state.params)
        loss, aux = ttrainer.make_loss_fn(prob)(params, state.colloc.to(dtype), None)
        leaves = k_taylor2.net_leaves(params["net"])
        grads[dtype] = [g.detach().numpy() for g in torch.autograd.grad(loss, leaves)]
        losses[dtype] = (loss, aux)
    taux = losses[torch.float32][1]
    for k in ("loss", "data_term", "res_term"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-4,
                                   err_msg=k)
    jleaves = [jgrad["net"][i][k] for i in range(len(TRUNK) - 1) for k in ("W", "b")]
    jleaves += [jgrad["net"][0][k] for k in tmlp.PATH_KEYS]
    for i, (g, w, e) in enumerate(zip(grads[torch.float32], jleaves, grads[torch.float64])):
        _assert_grad(f"leaf {i}", g.ravel(), np.asarray(w).ravel(), e.ravel())
    jstate1, _ = jax.jit(jtrainer.make_adam_step(jp, jtr.optimizer))(jstate)
    step = ttrainer.make_adam_step(tp, ttrainer.learning_rate_schedule(tp.exp.optimizer))
    state1, _ = step(state, new_colloc=torch.from_numpy(np.array(jstate1.colloc)))
    got = k_taylor2.net_leaves(state1.params["net"])
    want = [jstate1.params["net"][i][k] for i in range(len(TRUNK) - 1) for k in ("W", "b")]
    want += [jstate1.params["net"][0][k] for k in tmlp.PATH_KEYS]
    lr = tp.exp.optimizer.learning_rate
    for i, (g, w) in enumerate(zip(got, want)):
        # an Adam step moves each weight by at most about lr: hold the params
        # to a tenth of it
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0.1 * lr,
                                   err_msg=f"leaf {i}")


# -- interop, checkpoints ----------------------------------------------------------

def test_interop_round_trip_of_a_path_net(tmp_path):
    """params_from_jax / params_to_numpy, the params file (path leaves and
    the spec's path fields), train_state_from_jax / train_state_to_numpy
    with the path leaves' Adam moments, and a checkpoint."""
    _, tspec = specs()
    net = path_net(seed=20)
    back = interop.params_to_numpy(interop.params_from_jax(net, CPU))
    for a, b in zip(net, back):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    path = interop.save_params_npz(str(tmp_path / "p.npz"), tspec, net, 1.0, 1e-3,
                                   experiment="euler_weak_fast", pde="euler")
    loaded = interop.load_params_npz(path)
    assert loaded["spec"] == tspec
    for k in tmlp.PATH_KEYS:
        np.testing.assert_array_equal(loaded["params"][0][k], net[0][k])
    moments = [{k: np.full_like(v, 0.5) for k, v in layer.items()} for layer in net]
    coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.zeros(1, np.float32)}
    tree = {"params": {"net": net, "coeffs": coeffs}, "count": 3,
            "mu": {"net": moments, "coeffs": coeffs}, "nu": {"net": moments, "coeffs": coeffs},
            "colloc": numpy_points(8, 21), "epoch": 3}
    state = interop.train_state_from_jax(tree, CPU, key=5)
    assert state.opt_state.mu["net"][0]["path_a"].shape == (K,)
    again = interop.train_state_to_numpy(state)
    np.testing.assert_array_equal(again["nu"]["net"][0]["path_c"], moments[0]["path_c"])
    ckpt_io.save_checkpoint(str(tmp_path / "s.ckpt"), state)
    restored = ckpt_io.load_checkpoint(str(tmp_path / "s.ckpt"), "cpu")
    for a, b in zip(k_taylor2.net_leaves(state.params["net"]) +
                    k_taylor2.net_leaves(state.opt_state.mu["net"]),
                    k_taylor2.net_leaves(restored.params["net"]) +
                    k_taylor2.net_leaves(restored.opt_state.mu["net"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- what the slice leaves ---------------------------------------------------------

def test_check_slice_takes_the_slice_and_names_slice_2b_iii():
    """The path presets, and RAD and Fourier features on them (slice
    2b-iii's rest), pass check_slice; a Fourier path spec builds with JAX's
    input width [x, t, sin, cos, phi]."""
    for name in ("euler_weak", "euler_weak_fast", "euler_weak_tail"):
        ttrainer.check_slice(get_preset(name))
    ttrainer.check_slice(override(get_preset("euler_weak_tail"), {"sampling.strategy": "rad"}))
    ttrainer.check_slice(override(get_preset("euler_weak_fast"), {"model.n_fourier": 4}))
    spec = tmlp.MLPSpec(layers=TRUNK, lb=LB, ub=UB, fourier=((1.0, 2.0),), n_paths=K)
    jspec = jmlp.MLPSpec(layers=TRUNK, lb=LB, ub=UB, fourier=((1.0, 2.0),), n_paths=K)
    assert spec.widths[0] == jspec.embed_dim == 2 + 2 + K
    assert spec.n_params == jspec.n_params


def test_kernels_without_paths_refuse_a_path_spec():
    """Since slice 2b-iii K1/K2 and K5 take a path spec (K1 on its tiled
    design, K5 on its wide one at any width; on a CPU tensor they raise for
    the device, never for the paths); K6 (the mixed policy) raises naming
    ROADMAP queue 2 before any launch; K3's scope lists the features, so the
    trainer does not take it for abgrall_admm with paths."""
    _, burgers = specs(layers=(2, 20, 20, 1))
    net = interop.params_from_jax(path_net(layers=(2, 20, 20, 1), seed=30), CPU)
    x = torch.zeros(4, 2)
    for fn in (lambda: k_taylor2.taylor2(burgers, net, x),
               lambda: k_taylor2.taylor2_backward(burgers, net, x, [x[:, :1]] * 4),
               lambda: k5.mlp_forward(burgers, net, x),
               lambda: k5.mlp_backward(burgers, net, x, x[:, :1])):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            fn()
    mixed = dataclasses.replace(burgers, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP queue 2, K6"):
        k_taylor2.taylor2(mixed, net, x)
    assert k_taylor2.launch_config(burgers.widths).design == "tiled"
    exp = override(get_preset("abgrall_admm"), {"model.n_paths": 2})
    ttrainer.check_slice(exp)
    spec = tmlp.MLPSpec(layers=exp.model.layers, lb=LB, ub=UB, n_paths=2)
    assert any("shock-path" in why for why in k_fused.fused_step_supported(exp, spec))
    assert k5.design(spec.widths) == "wide"
    assert k5.design(dataclasses.replace(spec, n_paths=0).widths) == "narrow"
    with pytest.raises(ValueError, match="paths"):
        k7a.check_spec(dataclasses.replace(spec, n_paths=9))


def test_plans_widen_the_input_rows():
    """K7a's and K5's plans size H_0 by the embedded width and hold the
    paths' per-tile partials in the backward; a path net takes K7a's wide
    design, whose backward keeps every hidden layer's stacked outputs and
    takes one launch more for the paths' gradient."""
    _, spec = specs(layers=(2, 200, 200, 3))
    w = spec.widths
    assert w[0] == 4
    f, b = k7a.taylor1_plan(w, 1000), k7a.taylor1_plan(w, 1000, True, spec.n_path_params)
    n_pad = 1024
    assert f.h0 == b.h0 == 3 * n_pad * 8
    assert b.psums == 2 * (n_pad // 128) * spec.n_path_params and f.psums == 0
    assert f.design == b.design == "wide" and b.hbuf == 3 * n_pad * 204 * 2
    plain = k7a.taylor1_plan((2, 200, 200, 3), 1000, True)
    assert plain.h0 == 3 * n_pad * 4 and plain.psums == 0
    assert (f.launches, b.launches, plain.launches) == (4, 9, 8)
    _, narrow = specs(layers=(2, 20, 20, 3))
    assert k7a.default_design(narrow.widths) == "wide"
    assert k7a.default_design((2, 20, 20, 3)) == "narrow"
    kb = k5.mlp_backward_plan(w, 200, spec.n_path_params)
    assert kb.h0 == 256 * 8 and kb.psums == 2 * 2 * spec.n_path_params
    assert math.isclose(kb.scratch_floats, kb.sums + kb.h0 + kb.hidden + kb.gbuf
                        + kb.partials + kb.psums)
