"""Port parity for the weak-form slice (slice 2b-i: ``twosin_weak`` and
``euler_inverse``): the Gauss-Legendre nodes, the clipped cells and their
edge points, the Burgers and Euler flux residuals (viscous and inviscid,
with the weak entropy violation), the causal-in-time penalty, one loss and
gradient of each preset, and a step of each preset replayed against the
committed JAX fixture (``scripts/make_torch_weak_fixture.py``); and K7b's
backward algorithm, written out in PyTorch, against autograd.

Tolerances, each with its reason:
- the nodes, cells and edge points: 1e-12 (nodes, float64) and 1 ulp of the
  coordinates (float32; XLA may contract a multiply-add);
- the residuals and their gradients: the float64 criterion, the port's
  error against its own float64 version at most 4x JAX's float32 error
  plus 1e-6 max|exact| (a cell is 4% of the domain a side, so the
  difference quotient amplifies float32 rounding about 25x and each side's
  error is dominated by it), beside an absolute 1e-4 max|JAX| against JAX;
- the causal penalty: rtol 1e-5 (float32 sums in another order), the bin
  of every point exactly;
- losses rtol 1e-4; gradients rtol 1e-4 / atol 1e-5 max|g| per leaf, or the
  float64 criterion where a leaf's sum cancels;
- K7b's backward algorithm against autograd in float64: 1e-10 of each
  output's max.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.misfit import causal_residual_penalty as jax_causal
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops import weakform as jwf
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import params_from_jax, train_state_from_jax
from pinns_tpu_torch.losses.misfit import causal_residual_penalty
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops import weakform as twf
from pinns_tpu_torch.ops.kernels import weakform as k7b
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import numpy_params

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "weak_flux.npz")
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
TW_LB, TW_UB = (-1.0, 0.0), (1.0, 1.0)  # the TwoSin grid's bounds
SMALL = {"burgers": (2, 16, 16, 1), "euler": (2, 16, 16, 3)}
LAM1, LAM2, GAMMA, VISC = 0.377, 1e-3, 1.4, math.exp(-6.0)
F64_FACTOR, ABS_TO_JAX = 4.0, 1e-4
METRIC_KEYS = ttrainer.METRIC_KEYS


def _fixture():
    with np.load(FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _jnet(net):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def _net_from_flat(flat, layers):
    out, at = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        w = flat[at:at + din * dout].reshape(din, dout)
        at += din * dout
        out.append({"W": w, "b": flat[at:at + dout].reshape(1, dout)})
        at += dout
    return out


def _flat(ts):
    return np.concatenate([np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                                      np.float64).ravel() for t in ts])


def assert_f64(name, got, jax_out, exact):
    """The float64 criterion beside the absolute bound against JAX."""
    got, jax_out, exact = (np.asarray(a, np.float64) for a in (got, jax_out, exact))
    assert np.isfinite(got).all(), name
    err = np.abs(got - exact).max()
    jax_err = np.abs(jax_out - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"
    to_jax = np.abs(got - jax_out).max()
    assert to_jax <= ABS_TO_JAX * np.abs(jax_out).max() + 1e-30, \
        f"{name}: port vs JAX {to_jax} > {ABS_TO_JAX} max|JAX|"


def assert_grad(name, got, jax_out, exact):
    """A gradient: rtol 1e-4 / atol 1e-5 max|JAX|, or, where the sum over
    the cells cancels, the float64 criterion."""
    got, jax_out, exact = (np.asarray(a, np.float64) for a in (got, jax_out, exact))
    assert np.isfinite(got).all(), name
    if np.all(np.abs(got - jax_out) <= 1e-4 * np.abs(jax_out) + 1e-5 * np.abs(jax_out).max()):
        return
    err, jax_err = np.abs(got - exact).max(), np.abs(jax_out - exact).max()
    bound = F64_FACTOR * jax_err + 1e-6 * np.abs(exact).max()
    assert err <= bound, f"{name}: port vs f64 {err} > {bound} (JAX vs f64 {jax_err})"


def _grads(out, leaves):
    """torch.autograd.grad of ``out`` with a zero for a leaf it does not
    read (an inviscid residual and its viscosity)."""
    gs = torch.autograd.grad(out, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, leaves)]


def _centers(n, lb, ub, seed):
    """Uniform centers with rows on the bounds and within a half-width of
    them, as the fixture draws them."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(lb, ub, size=(n, 2)).astype(np.float32)
    hx, ht = 0.02 * (ub[0] - lb[0]), 0.02 * (ub[1] - lb[1])
    c[0], c[1], c[2], c[3] = (lb[0], lb[1]), (ub[0], ub[1]), (lb[0], ub[1]), (ub[0], lb[1])
    c[4:8, 0] = (lb[0], ub[0], lb[0] + 0.3 * hx, ub[0] - 0.7 * hx)
    c[8:12, 1] = (lb[1], ub[1], lb[1] + 0.4 * ht, ub[1] - 0.2 * ht)
    return c


# -- nodes, cells and edge points ----------------------------------------------

@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_gauss_legendre_matches_jax(q):
    for got, want in zip(twf.gauss_legendre(q), jwf._gauss_legendre(q)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("q", [2, 4])
def test_cells_and_edge_points_match_jax(q):
    """The clipped cells, the edge points in JAX's row order and the
    half-widths, centers on the bounds included."""
    c = _centers(64, TW_LB, TW_UB, seed=3)
    spec, jspec = MLPSpec(layers=(2, 4, 1), lb=TW_LB, ub=TW_UB), JSpec((2, 4, 1), TW_LB, TW_UB)
    hx, ht = 0.04, 0.02
    got = twf.cell_edges(spec, torch.from_numpy(c), hx, ht)
    want = jwf._cell_edges(jspec, jnp.asarray(c), hx, ht)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts, hxe, hte = twf.edge_points_reference(spec, torch.from_numpy(c), hx, ht, q)
    jpts, jhxe, jhte = jwf._edge_points(jspec, *want, q)
    ulp = np.spacing(np.float32(1.0))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts).reshape(-1, 2), rtol=ulp, atol=ulp)
    np.testing.assert_array_equal(hxe.numpy(), np.asarray(jhxe))
    np.testing.assert_array_equal(hte.numpy(), np.asarray(jhte))
    # the clipped cells stay inside the domain, and a center on a bound has
    # half its cell there
    assert pts[:, 0].min() >= TW_LB[0] and pts[:, 0].max() <= TW_UB[0]
    assert pts[:, 1].min() >= TW_LB[1] and pts[:, 1].max() <= TW_UB[1]
    assert float(hxe[0]) == pytest.approx(hx / 2, rel=1e-6)


def test_quad_sum_matches_jax():
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((16, 4, 3)).astype(np.float32)
    w = twf.gauss_legendre(4)[1].astype(np.float32)
    got = twf.quad_sum(torch.from_numpy(vals), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwf._quad(jnp.asarray(vals), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)


# -- the flux residuals ---------------------------------------------------------

def _burgers(net, c, viscous, dtype=torch.float32, want_entropy=True):
    spec = MLPSpec(layers=SMALL["burgers"], lb=TW_LB, ub=TW_UB, dtype=dtype)
    params = ([{k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in layer.items()}
               for layer in net])
    lam = [torch.tensor([v], dtype=dtype, requires_grad=True)
           for v in (LAM1, LAM2 if viscous else 0.0)]
    r, ent = twf.burgers_flux_residual(spec, params, torch.tensor(c, dtype=dtype), lam[0], lam[1],
                                       0.04, 0.02, 4, want_entropy, viscous)
    return r, ent, params, lam


@pytest.mark.parametrize("viscous", [True, False], ids=["viscous", "inviscid"])
def test_burgers_flux_residual_matches_jax(viscous):
    """r and the entropy violation, and the gradient of sum(r cot) in the
    net and both coefficients, against JAX (float64 criterion)."""
    net = numpy_params(SMALL["burgers"], seed=5)
    c = _centers(96, TW_LB, TW_UB, seed=6)
    cot = np.random.default_rng(7).standard_normal((96, 1)).astype(np.float32)
    jspec = JSpec(SMALL["burgers"], TW_LB, TW_UB)
    lam = (jnp.full((1,), LAM1), jnp.full((1,), LAM2 if viscous else 0.0))

    def jf(p, co):
        return jwf.burgers_flux_residual(jspec, p, jnp.asarray(c), co[0], co[1], 0.04, 0.02, 4,
                                         True, viscous)

    jr, jent = jf(_jnet(net), lam)
    jg = jax.grad(lambda p, co: jnp.sum(jf(p, co)[0] * cot), argnums=(0, 1))(_jnet(net), lam)
    out = {}
    for dtype in (torch.float32, torch.float64):
        r, ent, params, co = _burgers(net, c, viscous, dtype)
        leaves = [t for layer in params for t in (layer["W"], layer["b"])] + co
        g = _grads(torch.sum(r * torch.tensor(cot, dtype=dtype)), leaves)
        out[dtype] = (r.detach(), ent.detach(), g)
    (r, ent, g), (r64, ent64, g64) = out[torch.float32], out[torch.float64]
    assert r.shape == (96, 1) and ent.shape == (96, 1)
    assert_f64("r", r, jr, r64)
    assert_f64("entropy", ent, jent, ent64)
    jleaves = [jg[0][i][k] for i in range(len(net)) for k in ("W", "b")] + list(jg[1])
    for i, (a, b, e) in enumerate(zip(g, jleaves, g64)):
        assert_grad(f"grad leaf {i}", a, b, e)


def _euler(net, c, viscous, dtype=torch.float32, want_entropy=True):
    spec = MLPSpec(layers=SMALL["euler"], lb=TW_LB, ub=TW_UB, dtype=dtype)
    params = ([{k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in layer.items()}
               for layer in net])
    visc = torch.tensor([VISC if viscous else 0.0], dtype=dtype, requires_grad=True)
    rs, ent = twf.euler_flux_residuals(spec, params, torch.tensor(c, dtype=dtype), GAMMA, 0.04,
                                       0.02, 4, want_entropy, visc, viscous)
    return torch.cat(rs, dim=1), ent, params, visc


def _euler_net(seed):
    """A small Euler net whose outputs stay physical (rho, E > 0) so that the
    entropy's logarithms see positive arguments, as a trained net's do."""
    net = numpy_params(SMALL["euler"], seed)
    net[-1]["b"] = np.asarray([[1.0, 0.2, 2.5]], np.float32)
    net[-1]["W"] *= 0.2
    return net


@pytest.mark.parametrize("viscous", [True, False], ids=["viscous", "inviscid"])
def test_euler_flux_residuals_match_jax(viscous):
    net = _euler_net(8)
    c = _centers(96, TW_LB, TW_UB, seed=9)
    cot = np.random.default_rng(10).standard_normal((96, 3)).astype(np.float32)
    jspec = JSpec(SMALL["euler"], TW_LB, TW_UB)
    visc = jnp.full((1,), VISC if viscous else 0.0)

    def jf(p, v):
        rs, ent = jwf.euler_flux_residuals(jspec, p, jnp.asarray(c), GAMMA, 0.04, 0.02, 4, True,
                                           v, viscous)
        return jnp.concatenate(rs, axis=1), ent

    jr, jent = jf(_jnet(net), visc)
    jg = jax.grad(lambda p, v: jnp.sum(jf(p, v)[0] * cot), argnums=(0, 1))(_jnet(net), visc)
    out = {}
    for dtype in (torch.float32, torch.float64):
        r, ent, params, v = _euler(net, c, viscous, dtype)
        leaves = [t for layer in params for t in (layer["W"], layer["b"])] + [v]
        g = _grads(torch.sum(r * torch.tensor(cot, dtype=dtype)), leaves)
        out[dtype] = (r.detach(), ent.detach(), g)
    (r, ent, g), (r64, ent64, g64) = out[torch.float32], out[torch.float64]
    assert r.shape == (96, 3) and ent.shape == (96, 1)
    for i in range(3):
        assert_f64(f"r{i + 1}", r[:, i], jr[:, i], r64[:, i])
    assert_f64("entropy", ent, jent, ent64)
    jleaves = [jg[0][i][k] for i in range(len(net)) for k in ("W", "b")] + [jg[1]]
    for i, (a, b, e) in enumerate(zip(g, jleaves, g64)):
        assert_grad(f"grad leaf {i}", a, b, e)


def test_euler_entropy_pieces_match_jax():
    """The conserved variables, fluxes, entropy pair and d(eta)/dx."""
    rng = np.random.default_rng(11)
    y = np.stack([rng.uniform(0.2, 2, 64), rng.uniform(-1, 1, 64), rng.uniform(0.5, 3, 64)],
                 axis=1).astype(np.float32)
    yx = rng.standard_normal((64, 3)).astype(np.float32)
    got = twf.euler_conserved_flux(torch.from_numpy(y), GAMMA)
    want = jwf._euler_conserved_flux(jnp.asarray(y), GAMMA)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        twf.euler_entropy_x(torch.from_numpy(y), torch.from_numpy(yx), GAMMA).numpy(),
        np.asarray(jwf._euler_entropy_x(jnp.asarray(y), jnp.asarray(yx), GAMMA)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["burgers", "euler"])
def test_flux_residuals_match_the_fixture_at_full_width(kind):
    """The presets' full-width nets (8x20; the 2x200x5x3 trunk) at the
    fixture's 1,000 centers, bounds included: r and the gradient of sum(r
    cot), viscous and inviscid, against JAX's (float64 criterion)."""
    fx = _fixture()
    preset = "twosin_weak" if kind == "burgers" else "euler_inverse"
    layers = tuple(int(v) for v in fx[f"{preset}_layers"])
    lb, ub = tuple(fx[f"{preset}_lb"]), tuple(fx[f"{preset}_ub"])
    net = _net_from_flat(fx[f"{preset}_params_0"], layers)
    c, cot = fx[f"flux_{kind}_centers"], fx[f"flux_{kind}_cot"]
    hx, ht = 0.02 * (ub[0] - lb[0]), 0.02 * (ub[1] - lb[1])
    for tag, viscous in (("visc", True), ("invisc", False)):
        res = {}
        for dtype in (torch.float32, torch.float64):
            spec = MLPSpec(layers=layers, lb=lb, ub=ub, dtype=dtype)
            params = [{k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in l.items()}
                      for l in net]
            centers = torch.tensor(c, dtype=dtype)
            if kind == "burgers":
                co = [torch.tensor([v], dtype=dtype, requires_grad=True)
                      for v in (LAM1, LAM2 if viscous else 0.0)]
                r, _ = twf.burgers_flux_residual(spec, params, centers, co[0], co[1], hx, ht, 4,
                                                 False, viscous)
            else:
                co = [torch.tensor([VISC if viscous else 0.0], dtype=dtype, requires_grad=True)]
                rs, _ = twf.euler_flux_residuals(spec, params, centers, GAMMA, hx, ht, 4, False,
                                                 co[0], viscous)
                r = torch.cat(rs, dim=1)
            leaves = [t for l in params for t in (l["W"], l["b"])] + co
            g = _grads(torch.sum(r * torch.tensor(cot, dtype=dtype)), leaves)
            res[dtype] = (r.detach().numpy(), _flat(g[:len(g) - len(co)]), _flat(g[-len(co):]))
        (r, g, gc), (r64, g64, gc64) = res[torch.float32], res[torch.float64]
        want_gc = fx[f"flux_{kind}_{tag}_gcoeffs"]
        want_gc = want_gc if kind == "burgers" else want_gc[1:]
        assert_f64(f"{tag} r", r, fx[f"flux_{kind}_{tag}_r"], r64)
        assert_grad(f"{tag} grad", g, fx[f"flux_{kind}_{tag}_grad"], g64)
        assert_grad(f"{tag} gcoeffs", gc, want_gc, gc64)


@pytest.mark.parametrize("kind", ["burgers", "euler"])
def test_small_nets_match_the_fixture(kind):
    """The fixture's small nets (the card holds K7b at them too)."""
    fx = _fixture()
    lb, ub = (TW_LB, TW_UB) if kind == "burgers" else (
        tuple(fx["euler_inverse_lb"]), tuple(fx["euler_inverse_ub"]))
    layers = SMALL[kind]
    spec = MLPSpec(layers=layers, lb=lb, ub=ub)
    params = params_from_jax(_net_from_flat(fx[f"small_{kind}_params"], layers), CPU)
    c = torch.from_numpy(fx[f"small_{kind}_centers"])
    hx, ht = 0.02 * (ub[0] - lb[0]), 0.02 * (ub[1] - lb[1])
    for tag, viscous in (("visc", True), ("invisc", False)):
        if kind == "burgers":
            r, _ = twf.burgers_flux_residual(spec, params, c, LAM1, LAM2 if viscous else 0.0,
                                             hx, ht, 4, False, viscous)
        else:
            r = torch.cat(twf.euler_flux_residuals(spec, params, c, GAMMA, hx, ht, 4, False,
                                                   VISC if viscous else 0.0, viscous)[0], dim=1)
        want = fx[f"small_{kind}_r_{tag}"]
        np.testing.assert_allclose(r.numpy(), want, rtol=1e-4,
                                   atol=ABS_TO_JAX * np.abs(want).max(), err_msg=tag)


def test_entropy_on_cuda_raises_naming_the_slice():
    """Off the CPU the entropy goes to K7b's entropy mode (slice 2b-iii), not
    to the plain version: a tensor that is not on the CPU reaches K7b's
    wrappers, which raise for one that is not CUDA either (a meta tensor
    stands in for a CUDA one here) before any launch."""
    spec = MLPSpec(layers=SMALL["burgers"], lb=TW_LB, ub=TW_UB)
    c = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="K7b takes CUDA tensors"):
        twf.burgers_flux_residual(spec, [], c, 1.0, 0.0, 0.1, 0.1, 4, True, False)
    with pytest.raises(ValueError, match="K7b takes CUDA tensors"):
        twf.euler_flux_residuals(spec, [], c, GAMMA, 0.1, 0.1, 4, True)


# -- K7b's backward algorithm and its wrappers ----------------------------------

@pytest.mark.parametrize("kind,viscous", [("burgers", True), ("burgers", False),
                                          ("euler", True), ("euler", False)])
def test_k7b_backward_reference_matches_autograd(kind, viscous):
    """flux_backward_reference (the kernel's formulas) against autograd
    through the plain quadrature, in float64, at clipped cells."""
    n, q = 40, 4
    fields = 1 if kind == "burgers" else 3
    rng = np.random.default_rng(12)
    base = np.array([1.0, 0.3, 2.0])[:fields] if kind == "euler" else np.zeros(1)
    y = torch.tensor(base + 0.3 * rng.standard_normal((n * 4 * q, fields)), requires_grad=True)
    yx = torch.tensor(rng.standard_normal((n * 4 * q, fields)), requires_grad=True) \
        if viscous else None
    hxe = torch.tensor(rng.uniform(0.01, 0.02, (n, 1)))
    hte = torch.tensor(rng.uniform(0.005, 0.01, (n, 1)))
    c0 = torch.tensor([LAM1 if kind == "burgers" else GAMMA - 1.0], dtype=torch.float64,
                      requires_grad=kind == "burgers")
    c1 = torch.tensor([LAM2 if kind == "burgers" else VISC], dtype=torch.float64,
                      requires_grad=True)
    if kind == "burgers":
        r, _ = twf.burgers_quadrature_reference(y, yx, hxe, hte, c0, c1, q)
    else:
        r = torch.cat(twf.euler_quadrature_reference(y, yx, hxe, hte, GAMMA, c1, q)[0], dim=1)
    g_r = torch.tensor(rng.standard_normal((n, fields)))
    wrt = [y] + ([yx] if viscous else []) + ([c0, c1] if kind == "burgers" else [c1])
    want = torch.autograd.grad(r, wrt, g_r, allow_unused=True)
    coeffs = torch.cat([c0, c1]).detach()
    gy, gyx, gc = k7b.flux_backward_reference(kind, g_r, y.detach(),
                                              None if yx is None else yx.detach(), hxe, hte,
                                              coeffs, q)
    got = [gy] + ([gyx] if viscous else []) + ([gc[0:1], gc[1:2]] if kind == "burgers"
                                               else [gc[1:2]])
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10 * max(float(w.abs().max()), 1e-30),
                                   msg=f"output {i}")
    if kind == "euler":
        assert float(gc[0]) == 0.0


def test_k7b_wrappers_refuse_what_the_kernel_does_not_take():
    spec = MLPSpec(layers=SMALL["burgers"], lb=TW_LB, ub=TW_UB)
    cpu = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7b.edge_points(spec, cpu, 0.1, 0.1, 4)
    with pytest.raises(ValueError, match="quadrature nodes"):
        k7b.edge_points(spec, cpu, 0.1, 0.1, 9)
    y, h = torch.zeros((64, 1)), torch.ones((4, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7b.flux_quadrature("burgers", y, None, h, h, torch.zeros(2), 4)
    with pytest.raises(ValueError, match="unknown equation"):
        k7b.flux_forward("navier", y, None, h, h, torch.zeros(2), 4)


# -- the causal penalty -----------------------------------------------------------

@pytest.mark.parametrize("case", range(4), ids=["eps0", "eps30", "relative", "system"])
def test_causal_penalty_matches_jax_and_the_fixture(case):
    """The term and the weights against JAX live and against the fixture,
    at times on every bin edge, just above it and on the bounds."""
    fx = _fixture()
    eps, relative, fields = fx["causal_cases"][case]
    fields, relative = int(fields), bool(relative)
    t, res, bins = fx["causal_t"], fx["causal_res"], int(fx["causal_bins"])
    lb, ub = fx["causal_lb"], fx["causal_ub"]
    rs = tuple(res[:, j:j + 1] for j in range(fields))
    got, w = causal_residual_penalty(tuple(map(torch.from_numpy, rs)) if fields > 1
                                     else torch.from_numpy(rs[0]), torch.from_numpy(t), lb, ub,
                                     float(eps), bins, relative=relative)
    jterm, jw = jax_causal(tuple(map(jnp.asarray, rs)) if fields > 1 else jnp.asarray(rs[0]),
                           jnp.asarray(t), lb, ub, float(eps), bins, relative=relative)
    for want, want_w in ((jterm, jw), (fx[f"causal_term_{case}"], fx[f"causal_w_{case}"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-30)
    assert not w.requires_grad


def test_causal_bins_land_where_jax_puts_them():
    """Every point's bin, edges included, is JAX's (float32 operation order),
    and the per-bin sums follow from it."""
    fx = _fixture()
    t, bins = fx["causal_t"], int(fx["causal_bins"])
    lb, ub = fx["causal_lb"], fx["causal_ub"]
    frac = (jnp.asarray(t) - lb) / (ub - lb)
    jidx = np.asarray(jnp.clip((frac * bins).astype(jnp.int32), 0, bins - 1))
    # one point per bin with unit residual: each bin's L_b is its count share
    for b in range(bins):
        f = torch.from_numpy((jidx == b).astype(np.float32).reshape(-1, 1))
        _, w = causal_residual_penalty(f, torch.from_numpy(t), lb, ub, 1.0, bins)
        # the weights are 1 up to bin b and exp(-1) after it
        want = np.where(np.arange(bins) <= b, 1.0, math.exp(-1.0))
        np.testing.assert_allclose(w.numpy(), want, rtol=1e-6)


def test_causal_gradient_matches_jax():
    rng = np.random.default_rng(13)
    f = (0.2 * rng.standard_normal((200, 1))).astype(np.float32)
    t = rng.uniform(0, 1, 200).astype(np.float32)
    ft = torch.tensor(f, requires_grad=True)
    term, _ = causal_residual_penalty(ft, torch.from_numpy(t), np.float32(0), np.float32(1),
                                      30.0, 32)
    (g,) = torch.autograd.grad(term, ft)
    jg = jax.grad(lambda x: jax_causal(x, jnp.asarray(t), np.float32(0), np.float32(1), 30.0,
                                       32)[0])(jnp.asarray(f))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)


# -- the presets: slice check, loss and gradient, step replay ---------------------

def test_check_slice_lets_the_weak_presets_through():
    for name in ("twosin_weak", "euler_inverse"):
        ttrainer.check_slice(get_preset(name))
    ttrainer.check_slice(override(get_preset("twosin_weak"), {"pde.lambda2": 0.0}))
    # euler_weak and euler_weak_fast came with slice 2b-ii, the tail's
    # L-BFGS branch with slice 2b-iii's first part, Fourier features, the
    # weak-form ADMM, RAD and SWA with its rest
    for name in ("euler_weak", "euler_weak_fast", "euler_weak_tail"):
        ttrainer.check_slice(get_preset(name))
    for extra in ({"model.n_fourier": 4}, {"loss.admm_form": "flux"},
                  {"sampling.strategy": "rad"}, {"train.swa_frac": 0.25}):
        ttrainer.check_slice(override(get_preset("euler_weak_tail"), extra))


@pytest.mark.parametrize("extra,match", [
    ({"loss.grad_weight_kappa": 1.0}, "grad_weight_kappa"),
    ({"sampling.microbatch": 2}, "microbatch"),
], ids=["grad-weighting", "microbatch"])
def test_flux_residual_term_refuses_what_jax_refuses(extra, match):
    """The residual term's own guards (check_slice refuses the first one
    earlier; a problem built past it meets the guard)."""
    problem = _port_weak_problem("twosin_weak", {"model.layers": SMALL["burgers"],
                                                 "sampling.n_f": 64})
    problem = dataclasses.replace(problem, exp=override(problem.exp, extra))
    params = {"net": params_from_jax(numpy_params(SMALL["burgers"], 1), CPU),
              "coeffs": {"lambda1": torch.full((1,), LAM1), "lambda2": torch.full((1,), LAM2)}}
    with pytest.raises(ValueError, match=match):
        ttrainer.make_loss_fn(problem)(params, torch.rand(64, 2), None)


def _jax_weak_problem(preset, updates):
    exp = joverride(JPRESETS[preset], updates)
    if preset == "twosin_weak":
        with np.load(GRID) as z:
            ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                                 provenance=str(z["provenance"]))
        x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    else:
        ds = jds.load_euler_mat(exp.data.dataset)
        x_data, targets = jds.interior_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    return jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                            targets={k: jnp.asarray(v) for k, v in targets.items()})


def _port_weak_problem(preset, updates):
    return ttrainer.build_problem(override(get_preset(preset), updates), "cpu")


@pytest.mark.parametrize("preset,extra", [
    ("twosin_weak", {}), ("twosin_weak", {"pde.lambda2": 0.0}),
    ("twosin_weak", {"loss.causal_eps": 0.0}),
    ("twosin_weak", {"loss.causal_relative": True, "loss.causal_eps": 0.2}),
    ("euler_inverse", {}), ("euler_inverse", {"loss.causal_eps": 30.0}),
], ids=["twosin_weak", "inviscid", "no-causal", "causal-relative", "euler_inverse",
        "euler_inverse-causal"])
def test_weak_loss_and_grad_match_jax(preset, extra):
    """The preset's loss, its terms and the gradient of every leaf (the
    trainable viscosity of euler_inverse included) against JAX's at a small
    net and N_f 64."""
    kind = "burgers" if preset == "twosin_weak" else "euler"
    upd = {"model.layers": SMALL[kind], "sampling.n_f": 64, "data.n_u": 64, **extra}
    jp, tp = _jax_weak_problem(preset, upd), _port_weak_problem(preset, upd)
    np.testing.assert_array_equal(tp.x_data.numpy(), np.asarray(jp.x_data))
    net = _euler_net(14) if kind == "euler" else numpy_params(SMALL[kind], 14)
    coeffs = {"lambda1": np.full(1, LAM1 if kind == "burgers" else 1.0, np.float32),
              "lambda2": np.full(1, -6.0 if kind == "euler" else tp.exp.pde.lambda2, np.float32)}
    rng = np.random.default_rng(15)
    colloc = np.stack([rng.uniform(tp.lb[i], tp.ub[i], 64) for i in range(2)],
                      axis=1).astype(np.float32)
    colloc[:4] = [(tp.lb[0], tp.lb[1]), (tp.ub[0], tp.ub[1]), (tp.lb[0], tp.ub[1]),
                  (tp.ub[0], tp.lb[1])]
    jparams = {"net": _jnet(net), "coeffs": {k: jnp.asarray(v) for k, v in coeffs.items()}}
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jparams, jnp.asarray(colloc), None, None)
    params = {"net": params_from_jax(net, CPU),
              "coeffs": {k: torch.from_numpy(v) for k, v in coeffs.items()}}
    leaves = [t.requires_grad_(True) for layer in params["net"] for t in (layer["W"], layer["b"])]
    leaves += [params["coeffs"][k].requires_grad_(True) for k in ("lambda1", "lambda2")]
    tloss, taux = ttrainer.make_loss_fn(tp)(params, torch.from_numpy(colloc), None)
    tgrad = torch.autograd.grad(tloss, leaves, allow_unused=True)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    jflat = [jgrad["net"][i][k] for i in range(len(net)) for k in ("W", "b")]
    jflat += [jgrad["coeffs"][k] for k in ("lambda1", "lambda2")]
    for i, (g, w) in enumerate(zip(tgrad, jflat)):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("preset", ["twosin_weak", "euler_inverse"])
def test_weak_step_replays_the_fixture(preset):
    """The full-width preset from JAX's initial state (seed 1234): the loss
    and gradient, then the fixture's 3 Adam steps fed JAX's batches: the
    metrics, the coefficients and each leaf's sum and sum of squares."""
    fx = _fixture()
    p = f"{preset}_"
    problem = ttrainer.build_problem(get_preset(preset), "cpu")
    layers = tuple(int(v) for v in fx[p + "layers"])
    assert problem.spec.layers == layers
    assert problem.spec.lb == tuple(fx[p + "lb"]) and problem.spec.ub == tuple(fx[p + "ub"])
    np.testing.assert_array_equal(problem.x_data.numpy(), fx[p + "x_data"])
    net = _net_from_flat(fx[p + "params_0"], layers)
    c0 = fx[p + "coeffs_0"]
    coeffs = {"lambda1": c0[0:1], "lambda2": c0[1:2]}
    zeros = lambda tree: [{k: np.zeros_like(v) for k, v in l.items()} for l in tree]  # noqa: E731
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    state = train_state_from_jax({
        "params": {"net": net, "coeffs": coeffs}, "count": 0,
        "mu": {"net": zeros(net), "coeffs": zc}, "nu": {"net": zeros(net), "coeffs": zc},
        "colloc": fx[p + "colloc_0"], "epoch": 0}, CPU, key=int(fx[p + "seed"]))
    problem64 = ttrainer.build_problem(override(get_preset(preset), {"model.dtype": "float64"}),
                                       "cpu")
    flat = {}
    for dtype, prob in ((torch.float32, problem), (torch.float64, problem64)):
        params = ttrainer.tree_map(lambda t: t.to(dtype).clone().requires_grad_(True),
                                   state.params)
        loss, _ = ttrainer.make_loss_fn(prob)(params, state.colloc.to(dtype), None)
        leaves = ttrainer.tree_leaves(params["net"])
        grads = _grads(loss, leaves + [params["coeffs"][c] for c in ("lambda1", "lambda2")])
        flat[dtype] = (float(loss.detach()), grads)
    loss, grads = flat[torch.float32]
    np.testing.assert_allclose(loss, float(fx[p + "loss_0"]), rtol=1e-4)
    want, at = fx[p + "grad_0"], 0
    for i, (g, e) in enumerate(zip(grads[:-2], flat[torch.float64][1][:-2])):
        assert_grad(f"leaf {i}", g.numpy().ravel(), want[at:at + g.numel()],
                    e.numpy().ravel())
        at += g.numel()
    assert_grad("coeffs", _flat(grads[-2:]), fx[p + "gcoeffs_0"],
                _flat(flat[torch.float64][1][-2:]))
    step = ttrainer.make_adam_step(problem, ttrainer.learning_rate_schedule(
        problem.exp.optimizer))
    k = 1
    while f"{p}metrics_{k}" in fx:
        state, m = step(state, new_colloc=torch.from_numpy(fx[f"{p}colloc_{k}"]))
        got = {n: float(v) for n, v in m.items()}
        want_m = dict(zip(METRIC_KEYS, fx[f"{p}metrics_{k}"].tolist()))
        for n in ("loss", "data_term", "res_term", "lambda1", "lambda2"):
            np.testing.assert_allclose(got[n], want_m[n], rtol=1e-4,
                                       atol=1e-6 * abs(want_m["loss"]), err_msg=f"{n} step {k}")
        np.testing.assert_allclose(
            [float(state.params["coeffs"][c][0]) for c in ("lambda1", "lambda2")],
            fx[f"{p}coeffs_{k}"], rtol=1e-6, atol=1e-7, err_msg=f"coeffs step {k}")
        vals = [v.double().numpy() for layer in state.params["net"] for v in layer.values()]
        sums = np.asarray([(v.sum(), (v * v).sum()) for v in vals])
        np.testing.assert_allclose(sums, fx[f"{p}sums_{k}"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"leaf sums step {k}")
        np.testing.assert_array_equal(state.colloc.numpy(), fx[f"{p}colloc_{k}"])
        k += 1
    assert k == 4


# -- euler_weak_fast at full width (slice 2b-ii) ---------------------------------

EW_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "euler_weak.npz")


def _ew_fixture():
    with np.load(EW_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _path_net_from_flat(fx, flat):
    """A flat fixture vector (W_0, b_0, ..., path_c, path_a) as JAX-layout
    numpy params."""
    layers = tuple(int(v) for v in fx["layers"])
    k, d = int(fx["n_paths"]), int(fx["path_degree"])
    widths = (layers[0] + k,) + layers[1:]
    n_trunk = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    net = _net_from_flat(flat[:n_trunk], widths)
    net[0]["path_c"] = flat[n_trunk:n_trunk + k * (d + 1)].reshape(k, d + 1)
    net[0]["path_a"] = flat[n_trunk + k * (d + 1):]
    return net


def test_euler_weak_step_replays_the_fixture():
    """euler_weak_fast at full width (2x200x5x3, two shock paths, the strong
    mass equation) from JAX's initial state (seed 1234): the loss and every
    leaf's gradient, path_c and path_a included; then the fixture's 3 Adam
    steps fed JAX's batches: the metrics, the coefficients and each leaf's
    sum and sum of squares."""
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves

    fx = _ew_fixture()
    preset = "euler_weak_fast"
    problem = ttrainer.build_problem(get_preset(preset), "cpu")
    spec = problem.spec
    assert spec.layers == tuple(int(v) for v in fx["layers"])
    assert (spec.n_paths, spec.path_degree, spec.path_sharpness) == (
        int(fx["n_paths"]), int(fx["path_degree"]), float(fx["path_sharpness"]))
    assert spec.lb == tuple(fx["lb"]) and spec.ub == tuple(fx["ub"])
    np.testing.assert_array_equal(problem.x_data.numpy(), fx["x_data"])
    net = _path_net_from_flat(fx, fx["params_0"])
    c0 = fx["coeffs_0"]
    coeffs = {"lambda1": c0[0:1], "lambda2": c0[1:2]}
    zeros = lambda tree: [{k: np.zeros_like(v) for k, v in l.items()} for l in tree]  # noqa: E731
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    state = train_state_from_jax({
        "params": {"net": net, "coeffs": coeffs}, "count": 0,
        "mu": {"net": zeros(net), "coeffs": zc}, "nu": {"net": zeros(net), "coeffs": zc},
        "colloc": fx["colloc_0"], "epoch": 0}, CPU, key=int(fx["seed"]))
    problem64 = ttrainer.build_problem(override(get_preset(preset), {"model.dtype": "float64"}),
                                       "cpu")
    flat = {}
    for dtype, prob in ((torch.float32, problem), (torch.float64, problem64)):
        params = ttrainer.tree_map(lambda t: t.to(dtype).clone().requires_grad_(True),
                                   state.params)
        loss, _ = ttrainer.make_loss_fn(prob)(params, state.colloc.to(dtype), None)
        flat[dtype] = (float(loss.detach()), _grads(loss, net_leaves(params["net"])))
    loss, grads = flat[torch.float32]
    np.testing.assert_allclose(loss, float(fx["loss_0"]), rtol=1e-4)
    want, at = fx["grad_0"], 0
    assert sum(g.numel() for g in grads) == want.size == spec.n_params
    for i, (g, e) in enumerate(zip(grads, flat[torch.float64][1])):
        assert_grad(f"leaf {i}", g.numpy().ravel(), want[at:at + g.numel()], e.numpy().ravel())
        at += g.numel()
    step = ttrainer.make_adam_step(problem, ttrainer.learning_rate_schedule(
        problem.exp.optimizer))
    k = 1
    while f"metrics_{k}" in fx:
        state, m = step(state, new_colloc=torch.from_numpy(fx[f"colloc_{k}"]))
        got = {n: float(v) for n, v in m.items()}
        want_m = dict(zip(METRIC_KEYS, fx[f"metrics_{k}"].tolist()))
        for n in ("loss", "data_term", "res_term", "lambda1", "lambda2"):
            np.testing.assert_allclose(got[n], want_m[n], rtol=1e-4,
                                       atol=1e-6 * abs(want_m["loss"]), err_msg=f"{n} step {k}")
        np.testing.assert_allclose(
            [float(state.params["coeffs"][c][0]) for c in ("lambda1", "lambda2")],
            fx[f"coeffs_{k}"], rtol=1e-6, atol=1e-7, err_msg=f"coeffs step {k}")
        vals = [v.detach().double().numpy() for v in net_leaves(state.params["net"])]
        sums = np.asarray([(v.sum(), (v * v).sum()) for v in vals])
        np.testing.assert_allclose(sums, fx[f"sums_{k}"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"leaf sums step {k}")
        np.testing.assert_array_equal(state.colloc.numpy(), fx[f"colloc_{k}"])
        k += 1
    assert k == 4


def test_euler_weak_artifact_serves_the_fixture(tmp_path):
    """The first band seed's trained path net (2,000 JAX epochs) exported as
    an Euler artifact and served on the CPU at the fixture's grid points:
    rho, u, E and the three strong residuals within rtol 1e-5 / atol 1e-5
    max|JAX| of JAX's predict_fields."""
    from pinns_tpu_torch.serve import ServedModel, export_predict

    fx = _ew_fixture()
    problem = ttrainer.build_problem(get_preset("euler_weak_fast"), "cpu")
    net = _path_net_from_flat(fx, fx["band_params"])
    art = export_predict(problem.spec, net, str(tmp_path / "art"), lambda1=1.0, lambda2=1e-3,
                         experiment="euler_weak_fast", pde="euler", gamma=float(fx["gamma"]))
    served = ServedModel(art, device="cpu")
    assert served.spec == problem.spec
    np.testing.assert_array_equal(fx["predict_x"], problem.dataset.X_star[fx["predict_idx"]])
    out = served.predict(fx["predict_x"])
    for name in ("rho", "u", "E", "f1", "f2", "f3"):
        want = fx[f"predict_{name}"]
        np.testing.assert_allclose(out[name].ravel(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)
