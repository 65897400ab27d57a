"""Port parity for the Euler strong-form slice (``euler_admm``,
``euler_admm_tuned``): the exact Riemann grid, ``mlp_taylor_1`` and its
backward, the Euler residuals, the tuple ADMM, the time curriculum, the Euler
loss and step, prediction and serving, each held against the JAX package on
the same numpy inputs from a seed, and K7a's kernel layout written out in
PyTorch against the plain versions.

Tolerances: the grid to 1e-12 (the same float64 numpy on both sides); the
Taylor-1 streams and the fields rtol 1e-5 / atol 1e-5 max|.| (float32 sums
in other orders); f1 / f2 / f3 rtol 1e-5 / atol 1e-4 max|f| (they sum
products of three fields, which cancel); losses and gradients rtol 1e-4 /
atol 1e-5 max|g| per leaf; the reverse mode against autograd 1e-10 of each
leaf's max in float64; the K7a twin 1e-12 (float64) and 1e-5 (float32) of
each leaf's max.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.data import generators as jgen
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses import admm as jadmm
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.residuals import euler_pressure as jax_pressure
from pinns_tpu.ops.residuals import euler_residuals as jax_euler_residuals
from pinns_tpu.ops.taylor import mlp_taylor_1 as jax_taylor_1
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.data import datasets as tds
from pinns_tpu_torch.data import generators as tgen
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import params_from_jax, save_params_npz, train_state_from_jax
from pinns_tpu_torch.losses import admm as tadmm
from pinns_tpu_torch.models.mlp import MLPSpec, input_scale, normalize_inputs
from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
from pinns_tpu_torch.ops.residuals import euler_pressure, euler_residuals
from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_1_reference
from pinns_tpu_torch.serve import ServedModel, export_predict
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer
from pinns_tpu_torch.train.evaluate import euler_fields, predict_fields
from torch_port_util import LB, UB, numpy_params, numpy_points

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "euler_admm.npz")
EULER_SMALL = (2, 16, 16, 3)
EULER = (2,) + (200,) * 5 + (3,)
FIELDS = ("rho", "u", "E")
RES = ("f1", "f2", "f3")
TOL = {"field": (1e-5, 1e-5), "res": (1e-5, 1e-4)}
METRIC_KEYS = ttrainer.METRIC_KEYS


def _close(got, want, kind, name=""):
    rtol, atol_rel = TOL[kind]
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=name)


def _close_grad(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def _jparams(net):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def _flat_leaves(flat, layers):
    """A flat (W_0, b_0, W_1, ...) vector cut into its leaves."""
    out, at = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        for shape in ((din, dout), (1, dout)):
            size = int(np.prod(shape))
            out.append(np.asarray(flat[at:at + size]).reshape(shape))
            at += size
    return out


def _net_from_flat(flat, layers):
    leaves = _flat_leaves(flat, layers)
    return [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]


# -- the exact Riemann grid ----------------------------------------------------

RIEMANN = {
    "blend": jgen.blend_primitives(),
    "sod": ((1.0, 0.0, 1.0), (0.125, 0.0, 0.1)),
    "two_shocks": ((1.0, 2.0, 1.0), (1.0, -2.0, 1.0)),
    "two_rarefactions": ((1.0, -1.0, 0.4), (1.0, 1.0, 0.4)),
}


@pytest.mark.parametrize("case", sorted(RIEMANN))
def test_exact_riemann_matches_jax(case):
    """The port's copy of the exact Riemann solver against JAX's, at every
    wave branch (shock / rarefaction on either side), to 1e-12."""
    left, right = RIEMANN[case]
    x = np.linspace(0.0, 1.0, 301)
    for t in (1e-3, 0.05, 0.2):
        got = tgen.euler_exact_riemann(x, t, left, right)
        want = jgen.euler_exact_riemann(x, t, left, right)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=f"{case} t={t}")
    assert tgen.blend_primitives() == jgen.blend_primitives()


def test_euler_grid_matches_jax(monkeypatch):
    """make_abgrall_eulers_grid and the loaded dataset against JAX's native
    grid, to 1e-12 (float64) and exactly (the float32 GridDataset)."""
    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    got, want = tgen.make_abgrall_eulers_grid(), jgen.make_abgrall_eulers_grid()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12, err_msg=key)
    assert (tgen.EULER_T0, tgen.EULER_DT) == (jgen.EULER_T0, jgen.EULER_DT)
    ds = tds.load_euler_mat("abgrall_eulers")
    jd = jds.GridDataset(x=want["x"], t=want["t"], fields={
        "rho": want["rhosol"].T, "u": want["usol"].T, "E": want["Enersol"].T})
    assert ds.provenance == "native" and ds.field_names == FIELDS
    assert ds.fields["rho"].shape == (157, 300) and ds.n_points == 47_100
    np.testing.assert_array_equal(ds.X_star, jd.X_star)
    for name in FIELDS:
        np.testing.assert_array_equal(ds.star[name], jd.star[name])
    np.testing.assert_array_equal(ds.lb, jd.lb)
    np.testing.assert_array_equal(ds.ub, jd.ub)


def test_euler_grid_matches_the_fixture():
    """The fixture's sampled grid values (written by JAX) against the port's
    native grid, to 1e-12."""
    d = tgen.make_abgrall_eulers_grid()
    with np.load(FIXTURE) as z:
        np.testing.assert_allclose(d["x"].ravel(), z["grid_x"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(d["t"].ravel(), z["grid_t"], rtol=0, atol=1e-12)
        xi, ti = z["grid_idx"][:, 0], z["grid_idx"][:, 1]
        for name, key in zip(FIELDS, ("rhosol", "usol", "Enersol")):
            np.testing.assert_allclose(d[key][xi, ti], z[f"grid_{name}"], rtol=1e-12,
                                       atol=1e-12, err_msg=name)


def test_euler_loader_paths(tmp_path, monkeypatch):
    """An explicit .npz path and a reference .mat under PINNS_TPU_DATA_ROOT
    are read as stored grids; an unknown key raises."""
    d = tgen.make_abgrall_eulers_grid(nx=11, nt=5)
    path = tmp_path / "small_euler.npz"
    np.savez(path, **d, provenance=np.asarray("native"))
    ds = tds.load_euler_mat(str(path))
    assert ds.fields["u"].shape == (5, 11) and ds.name == "small_euler"
    import scipy.io

    (tmp_path / "Eulers" / "Data").mkdir(parents=True)
    scipy.io.savemat(tmp_path / "Eulers" / "Data" / "Abgrall_eulers.mat", d)
    monkeypatch.setenv("PINNS_TPU_DATA_ROOT", str(tmp_path))
    stored = tds.load_euler_mat("abgrall_eulers")
    assert stored.provenance == "stored" and stored.fields["E"].shape == (5, 11)
    with pytest.raises(FileNotFoundError, match="neither a known key"):
        tds.load_euler_mat("no_such_euler_grid")


# -- mlp_taylor_1 and its backward ----------------------------------------------

@pytest.mark.parametrize("layers", [EULER_SMALL, (2, 24, 3), (2, 3)],
                         ids=["16x2", "24x1", "no-hidden"])
def test_mlp_taylor_1_matches_jax(layers):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    jnet = numpy_params(layers, seed=51)
    x = numpy_points(257, seed=52)
    got = mlp_taylor_1(spec, params_from_jax(jnet, CPU), torch.from_numpy(x))
    want = jax_taylor_1(JSpec(layers=layers, lb=LB, ub=UB), _jparams(jnet), jnp.asarray(x))
    for name, g, w in zip(("y", "y_x", "y_t"), got, want):
        w = np.broadcast_to(np.asarray(w), (257, layers[-1]))
        assert tuple(g.shape) == (257, layers[-1]) and g.dtype == torch.float32
        _close(g.numpy(), w, "field", name)


def test_mlp_taylor_1_is_the_first_order_part_of_taylor_2():
    """The value and first-derivative streams of mlp_taylor_1 are those of
    mlp_taylor_2 on the same net (the same products, the same order)."""
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    spec = MLPSpec(layers=EULER_SMALL, lb=LB, ub=UB)
    net = params_from_jax(numpy_params(EULER_SMALL, 53), CPU)
    x = torch.from_numpy(numpy_points(65, 54))
    for a, b in zip(mlp_taylor_1_reference(spec, net, x), mlp_taylor_2_reference(spec, net, x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layers", [EULER_SMALL, (2, 30, 20, 10, 3)], ids=["16x2", "30-20-10"])
def test_taylor1_backward_reference_matches_autograd(layers):
    """K7a's plain reverse mode equals torch.autograd through the plain
    recurrence, to 1e-10 of each leaf's max, in float64."""
    dt = torch.float64
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dt)
    net = [{k: torch.tensor(v, dtype=dt, requires_grad=True) for k, v in layer.items()}
           for layer in numpy_params(layers, 55)]
    x = torch.tensor(numpy_points(97, 56), dtype=dt)
    rng = np.random.default_rng(57)
    cot = [torch.tensor(rng.standard_normal((97, layers[-1])), dtype=dt) for _ in range(3)]
    outs = mlp_taylor_1_reference(spec, net, x)
    leaves = [t for layer in net for t in (layer["W"], layer["b"])]
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), leaves)
    got = k_taylor1.taylor1_backward_reference(
        spec, [{k: v.detach() for k, v in layer.items()} for layer in net], x, cot)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10 * float(w.abs().max()), err_msg=f"leaf {i}")


def test_taylor1_vjp_matches_jax():
    """The float32 reverse mode against jax.vjp of JAX's mlp_taylor_1."""
    spec = MLPSpec(layers=EULER_SMALL, lb=LB, ub=UB)
    jnet = numpy_params(EULER_SMALL, 58)
    x = numpy_points(129, 59)
    rng = np.random.default_rng(60)
    cot = [rng.standard_normal((129, 3)).astype(np.float32) for _ in range(3)]
    jspec = JSpec(layers=EULER_SMALL, lb=LB, ub=UB)
    _, vjp = jax.vjp(lambda p: jax_taylor_1(jspec, p, jnp.asarray(x)), _jparams(jnet))
    (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cot))
    got = k_taylor1.taylor1_backward_reference(
        spec, params_from_jax(jnet, CPU), torch.from_numpy(x), [torch.from_numpy(c) for c in cot])
    want = [jgrad[i][k] for i in range(len(EULER_SMALL) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(got, want)):
        _close_grad(g.numpy(), w, f"leaf {i}")


# -- K7a's layout and order, written out in PyTorch -------------------------------

def _k7a_order(spec, params, x, cot):
    """(y, y_x, y_t) and the gradient as csrc/taylor1.cu's wide design lays
    them out and sums them: the three streams of n_pad points (padded points
    at (0, 0), zero cotangents) stacked stream-major with the bias's
    indicator column (1 on value rows, 0 on derivative rows), so a layer is
    one product H [W; b]; every layer's outputs kept; the head's three
    streams; dW = H^T G over the plan's split chunks, the partials summed in
    split order; db = the value rows of G summed per three-stream tile of
    points (GRAD_TILE_POINTS), then over the tiles; gH = G W^T; the rule's
    adjoint at the kept outputs (s, hx, ht): d1 gh - 2 s (ghx hx + ght ht)."""
    plan = k_taylor1.taylor1_plan(spec.layers, x.shape[0], backward=True, design="wide")
    dtype, n, n_pad = spec.dtype, x.shape[0], plan.n_pad
    xp = torch.zeros((n_pad, 2), dtype=dtype)
    xp[:n] = x
    h = normalize_inputs(spec, xp)
    scale = input_scale(spec, xp.device)
    ex, et = torch.zeros_like(h), torch.zeros_like(h)
    ex[:, 0], et[:, 1] = scale[0], scale[1]

    def stack(streams):
        return torch.cat([torch.cat([s, torch.full_like(s[:, :1], float(i == 0))], dim=1)
                          for i, s in enumerate(streams)])

    H = [stack((h, ex, et))]
    for layer in params[:-1]:
        p = H[-1] @ torch.cat([layer["W"], layer["b"]])
        s = torch.tanh(p[:n_pad])
        d1 = 1.0 - s * s
        H.append(stack((s, d1 * p[n_pad:2 * n_pad], d1 * p[2 * n_pad:])))
    head = H[-1] @ torch.cat([params[-1]["W"], params[-1]["b"]])
    outs = tuple(head[i * n_pad:i * n_pad + n] for i in range(3))
    pad = lambda g: torch.cat([g, torch.zeros((n_pad - n, g.shape[1]), dtype=dtype)])  # noqa: E731
    G = torch.cat([pad(g) for g in cot])
    grads = [None] * (2 * len(params))
    for l in range(len(params) - 1, -1, -1):
        dW = torch.zeros_like(params[l]["W"])
        for z in range(plan.splits):
            rows = slice(z * plan.split_rows, (z + 1) * plan.split_rows)
            dW = dW + H[l][rows, :-1].T @ G[rows]
        grads[2 * l] = dW
        tile = k_taylor1.GRAD_TILE_POINTS
        grads[2 * l + 1] = sum(G[t:t + tile].sum(dim=0, keepdim=True)
                               for t in range(0, n_pad, tile))
        if l > 0:
            gh = G @ params[l]["W"].T
            h = H[l][:, :-1]
            s, hx, ht = h[:n_pad], h[n_pad:2 * n_pad], h[2 * n_pad:]
            d1 = 1.0 - s * s
            g0, gx, gt = gh[:n_pad], gh[n_pad:2 * n_pad], gh[2 * n_pad:]
            G = torch.cat([d1 * g0 - 2.0 * s * (gx * hx + gt * ht), gx * d1, gt * d1])
    return outs, grads


K7A_ORDER_CASES = [(layers, n, dtype) for layers in (EULER_SMALL, (2, 40, 40, 3), (2, 3))
                   for n in (1, 37, 300) for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize(
    "layers,n,dtype", K7A_ORDER_CASES,
    ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}-{str(c[2])[6:]}" for c in K7A_ORDER_CASES])
def test_k7a_layout_and_order_match_the_plain_versions(layers, n, dtype):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dtype)
    params = [{k: torch.tensor(v, dtype=dtype) for k, v in layer.items()}
              for layer in numpy_params(layers, 61)]
    x = torch.tensor(numpy_points(n, 62), dtype=dtype)
    rng = np.random.default_rng(63)
    cot = [torch.tensor(rng.standard_normal((n, layers[-1])) / n, dtype=dtype) for _ in range(3)]
    outs, grads = _k7a_order(spec, params, x, cot)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    want = list(mlp_taylor_1_reference(spec, params, x)) + \
        k_taylor1.taylor1_backward_reference(spec, params, x, cot)
    for i, (g, w) in enumerate(zip(list(outs) + grads, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()), err_msg=f"output {i}")


K7A_PLAN_CASES = [(layers, n) for layers in (EULER, (2, 20, 20, 20, 3))
                  for n in (1, 200, 1_000, 8_192, 47_100, 65_536)]


@pytest.mark.parametrize("layers,n", K7A_PLAN_CASES,
                         ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}" for c in K7A_PLAN_CASES])
def test_k7a_plan_fits_its_layout(layers, n):
    """K7a's wide plans (the narrow net's too, asked for by name): the
    padding is whole row tiles, the tile one the kernel instantiates, the
    splits cover the 3 n_pad stacked rows exactly in chunks of at most 1,024
    rows, db's per-tile sums follow the three-stream tiles, and the scratch's
    parts lie on 16 bytes and add up to it; a narrow plan's blocks cover the
    points."""
    fwd = k_taylor1.taylor1_plan(layers, n, design="wide")
    bwd = k_taylor1.taylor1_plan(layers, n, True, design="wide")
    for plan in (fwd, bwd):
        assert plan.design == "wide"
        assert plan.n_pad % k_taylor1.EW_TILE == 0 and n <= plan.n_pad < n + k_taylor1.EW_TILE
        assert plan.tile in (k_taylor1.SMALL_TILE, k_taylor1.LARGE_TILE)
        assert all(part % 4 == 0 for part in plan.parts) and sum(plan.parts) == plan.scratch_floats
    rows = 3 * bwd.n_pad
    assert bwd.split_rows % k_taylor1.SPLIT_STEP == 0 and bwd.split_rows <= 1024
    assert (bwd.splits - 1) * bwd.split_rows < rows <= bwd.splits * bwd.split_rows
    assert fwd.tile == bwd.tile and fwd.splits == 0 and fwd.gbuf == 0
    tiles = bwd.n_pad // k_taylor1.GRAD_TILE_POINTS
    assert bwd.sums == -(-2 * (len(layers) - 1) * tiles * max(layers) // 4) * 4
    if k_taylor1.default_design(layers) == "narrow":
        for backward, launches in ((False, 1), (True, 2)):
            plan = k_taylor1.taylor1_plan(layers, n, backward)
            assert plan.design == "narrow" and plan.launches == launches
            assert plan.tile % 4 == 0 and plan.grid >= 1
            assert backward or plan.grid * plan.tile >= n


def test_k7a_plan_at_the_euler_shapes():
    """The Euler trunk: the batch's 1,000 points on the small tile in
    96-row chunks, 65,536 points on the large tile; 7 launches forward and
    14 backward; the backward's scratch at 65,536 points within twice the
    one that stored P of every hidden layer beside one layer's inputs."""
    shape = lambda p: (p.tile, p.n_pad, p.split_rows, p.splits)  # noqa: E731
    assert shape(k_taylor1.taylor1_plan(EULER, 1_000, True)) == (32, 1_024, 96, 32)
    big = k_taylor1.taylor1_plan(EULER, 65_536, True)
    assert shape(big) == (128, 65_536, 512, 384)
    assert k_taylor1.taylor1_plan(EULER, 1_000).tile == 32
    assert k_taylor1.taylor1_plan(EULER, 1_000).launches == 7 and big.launches == 14
    rows, wmax = 3 * 65_536, 200
    single = (2 * 6 * (65_536 // 128) * wmax + rows * 4 + rows * 1_000 + rows * 204
              + 2 * rows * wmax + big.partials)
    assert big.scratch_floats <= 2 * single


def test_k7a_refuses_cpu_tensors_and_mixed_specs():
    spec = MLPSpec(layers=EULER_SMALL, lb=LB, ub=UB)
    net = params_from_jax(numpy_params(EULER_SMALL, 64), CPU)
    x = torch.from_numpy(numpy_points(8, 65))
    with pytest.raises(ValueError, match="CUDA"):
        k_taylor1.taylor1(spec, net, x)
    with pytest.raises(ValueError, match="CUDA"):
        k_taylor1.taylor1_backward(spec, net, x, [torch.zeros(8, 3)] * 3)
    mixed = MLPSpec(layers=EULER_SMALL, lb=LB, ub=UB, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="later slice"):
        k_taylor1.check_spec(mixed)
    assert k_taylor1.LAUNCHES == 0 and k_taylor1.BACKWARD_LAUNCHES == 0


# -- residuals and the tuple ADMM ------------------------------------------------

@pytest.mark.parametrize("gamma", [1.4, 5.0 / 3.0])
def test_euler_residuals_match_jax(gamma):
    spec = MLPSpec(layers=EULER_SMALL, lb=LB, ub=UB)
    jnet = numpy_params(EULER_SMALL, seed=66)
    x = numpy_points(301, seed=67)
    (fields, res) = euler_residuals(spec, params_from_jax(jnet, CPU), torch.from_numpy(x), gamma)
    jfields, jres = jax_euler_residuals(JSpec(layers=EULER_SMALL, lb=LB, ub=UB), _jparams(jnet),
                                        jnp.asarray(x), gamma)
    for name, g, w in zip(FIELDS, fields, jfields):
        assert tuple(g.shape) == (301, 1)
        _close(g.numpy(), w, "field", name)
    for name, g, w in zip(RES, res, jres):
        _close(g.numpy(), w, "res", name)
    rho, u, e = (np.array(v) for v in jfields)
    _close(euler_pressure(*(torch.from_numpy(v) for v in (rho, u, e)), gamma).numpy(),
           jax_pressure(rho, u, e, gamma), "field", "p")


def _vec(seed, n=64, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, 1))).astype(np.float32)


@pytest.mark.parametrize("explicit_inner", [False, True])
def test_tuple_admm_matches_jax(explicit_inner):
    """The tuple ADMM (one state a component, one threshold 1/(rho N_f))
    against JAX's: init, penalty, the z-then-dual update and the misfit."""
    rho = 40.0
    f0 = tuple(_vec(70 + i, scale=0.3) for i in range(3))
    f = tuple(_vec(80 + i, scale=0.3) for i in range(3))
    dual = tuple((1.0 + _vec(90 + i, scale=0.1)) for i in range(3))
    tt = lambda vs: tuple(torch.from_numpy(v) for v in vs)  # noqa: E731
    jj = lambda vs: tuple(jnp.asarray(v) for v in vs)  # noqa: E731
    ts, js = tadmm.admm_init(tt(f0)), jadmm.admm_init(jj(f0))
    for a, b in zip(ts.z + ts.dual, js.z + js.dual):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts = tadmm.ADMMState(z=ts.z, dual=tt(dual))
    js = jadmm.ADMMState(z=js.z, dual=jj(dual))
    np.testing.assert_allclose(float(tadmm.admm_penalty(tt(f), ts, rho, explicit_inner)),
                               float(jadmm.admm_penalty(jj(f), js, rho, explicit_inner)),
                               rtol=1e-5)
    tn, jn = tadmm.admm_update(tt(f), ts, rho, 64), jadmm.admm_update(jj(f), js, rho, 64)
    for a, b in zip(tn.z, jn.z):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    for a, b in zip(tn.dual, jn.dual):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tadmm.admm_misfit(tt(f), tn)),
                               float(jadmm.admm_misfit(jj(f), jn)), rtol=1e-5)
    # a one-component tuple is the single-residual form, bit for bit
    single = tadmm.admm_update(torch.from_numpy(f[0]),
                               tadmm.ADMMState(z=ts.z[0], dual=ts.dual[0]), rho, 64)
    assert torch.equal(single.z, tn.z[0]) and torch.equal(single.dual, tn.dual[0])


# -- the time curriculum ------------------------------------------------------

def test_curriculum_bounds_match_jax():
    """_curriculum_bounds of euler_admm_tuned (t-range growing over 100,000
    epochs from a 5% floor) equal JAX's at several epochs, and the batch of
    draw e + 1 takes the bounds of JAX's epoch e."""
    exp = get_preset("euler_admm_tuned")
    ds = tds.GridDataset(x=np.linspace(0, 1, 5), t=np.linspace(0.002032, 0.2008228, 4),
                         fields={"rho": np.zeros((4, 5))})
    tp = ttrainer.Problem(exp=exp, dataset=ds, spec=None, x_data=None, targets={})
    jp = jtrainer.Problem(exp=JPRESETS["euler_admm_tuned"], dataset=ds,
                          spec=JSpec(layers=exp.model.layers, lb=tuple(ds.lb), ub=tuple(ds.ub)),
                          x_data=None, targets={})
    for epoch in (0, 1, 4_999, 5_000, 12_345, 99_998, 99_999, 250_000):
        lb, ub = ttrainer._curriculum_bounds(tp, epoch)
        jlb, jub = jtrainer._curriculum_bounds(jp, jnp.asarray(epoch, jnp.int32))
        np.testing.assert_array_equal(np.asarray(lb, np.float32), np.asarray(jlb))
        np.testing.assert_array_equal(np.asarray(ub, np.float32), np.asarray(jub), f"{epoch}")
    assert float(ttrainer._curriculum_bounds(tp, 0)[1][1]) < float(ds.ub[1])
    plain = dataclasses.replace(tp, exp=get_preset("euler_admm"))
    assert ttrainer._curriculum_bounds(plain, 10)[1] is ds.ub
    spec = MLPSpec(layers=EULER_SMALL, lb=tuple(ds.lb), ub=tuple(ds.ub))
    tp = dataclasses.replace(tp, spec=spec)
    for draw, epoch in ((0, 0), (1, 0), (2, 1), (70_001, 70_000)):
        pts = ttrainer._resample(tp, 1234, draw)
        lb, ub = ttrainer._curriculum_bounds(tp, epoch)
        assert float(pts[:, 1].max()) < float(ub[1]) and float(pts[:, 1].min()) >= float(lb[1])


# -- the Euler problem, loss and step -----------------------------------------------

def _jax_euler_problem(updates):
    exp = joverride(JPRESETS["euler_admm"], updates)
    g = jgen.make_abgrall_eulers_grid()
    ds = jds.GridDataset(x=g["x"], t=g["t"], fields={"rho": g["rhosol"].T, "u": g["usol"].T,
                                                      "E": g["Enersol"].T}, provenance="native")
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    return jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                            targets={k: jnp.asarray(v) for k, v in targets.items()})


def _port_euler_problem(updates):
    return ttrainer.build_problem(override(get_preset("euler_admm"), updates), "cpu")


def test_euler_presets_build_like_jax(monkeypatch):
    """check_slice lets both strong-form presets through; build_problem gives
    the native grid and JAX's IC/BC training set of three targets."""
    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    for name in ("euler_admm", "euler_admm_tuned"):
        ttrainer.check_slice(get_preset(name))
    tp, jp = _port_euler_problem({}), _jax_euler_problem({})
    assert tp.spec.layers == EULER and tp.euler
    assert tp.spec.lb == jp.spec.lb and tp.spec.ub == jp.spec.ub
    np.testing.assert_array_equal(tp.x_data.numpy(), np.asarray(jp.x_data))
    assert sorted(tp.targets) == sorted(FIELDS)
    for name in FIELDS:
        np.testing.assert_array_equal(tp.targets[name].numpy(), np.asarray(jp.targets[name]))


DEFERRED = {
    "weak_form": {"loss.admm_form": "flux"},
    "entropy": {"loss.entropy_weight": 0.1},
    "gradient_weighting": {"loss.grad_weight_kappa": 1.0},
    "strong_equations": {"loss.strong_equations": (0,)},
    "lbfgs": {"optimizer.kind": "hybrid"},
    "paths": {"model.n_paths": 2},
    "fourier": {"model.n_fourier": 4},
    "rad": {"sampling.strategy": "rad"},
}
DEFERRED_MATCH = {"weak_form": "weak-form", "entropy": "entropy", "gradient_weighting":
                  "gradient weighting", "strong_equations": "strong equations",
                  "lbfgs": "L-BFGS", "paths": "shock-path", "fourier": "Fourier features",
                  "rad": "RAD"}


# deferred by the Euler strong-form slice and ported since: the mixed
# formulation and the shock paths by slice 2b-ii, the entropy penalty,
# gradient weighting and the Euler L-BFGS branch by slice 2b-iii's first
# part, the weak-form ADMM, Fourier features and RAD by its rest
PORTED = set(DEFERRED)


@pytest.mark.parametrize("feature", sorted(DEFERRED))
def test_check_slice_refuses_deferred_euler_features(feature):
    """Every Euler feature the strong-form slice deferred is ported: each
    passes check_slice, and since slice 6 each passes it under data
    parallelism too, but RAD, whose draw over the whole pool is left to
    slice 6b: its refusal names RAD and slice 6b, not slice 2b-iii."""
    assert feature in PORTED
    exp = override(get_preset("euler_admm"), DEFERRED[feature])
    ttrainer.check_slice(exp)
    dp = override(exp, {"mesh.data_parallel": 2})
    if feature != "rad":
        ttrainer.check_slice(dp)
        return
    with pytest.raises(NotImplementedError, match="slice 6b") as err:
        ttrainer.check_slice(dp)
    assert DEFERRED_MATCH[feature] in str(err.value)
    assert "2b-iii" not in str(err.value)


LOSS_CASES = [("admm", 1, {}), ("admm", 2, {}), ("mean_sq", 1, {}), ("l1_sq_norm", 2, {}),
              ("admm", 1, {"loss.data_field_weights": (3.0, 1.0, 1.0)}),
              ("l2_sq_norm", 1, {"loss.data_weight": 2.0, "loss.residual_weight": 0.5})]
LOSS_IDS = ["admm", "admm-mb2", "mean_sq", "l1_sq_norm-mb2", "admm-field-weights",
            "l2_sq_norm-weights"]


@pytest.mark.parametrize("kind,mb,extra", LOSS_CASES, ids=LOSS_IDS)
def test_euler_loss_and_grad_match_jax(kind, mb, extra):
    """The Euler loss (three residuals, the three-field data term) and its
    gradient against JAX's at a small net, N_f 64."""
    upd = {"model.layers": EULER_SMALL, "sampling.n_f": 64, "sampling.microbatch": mb,
           "loss.residual_kind": kind, **extra}
    jp, tp = _jax_euler_problem(upd), _port_euler_problem(upd)
    jnet = numpy_params(EULER_SMALL, 71)
    colloc = np.stack([np.random.default_rng(72).uniform(tp.lb[i], tp.ub[i], 64)
                       for i in range(2)], axis=1).astype(np.float32)
    z = tuple(_vec(73 + i, scale=0.2) for i in range(3))
    dual = tuple(1.0 + _vec(76 + i, scale=0.1) for i in range(3))
    coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.zeros(1, np.float32)}
    jadmm_state = jadmm.ADMMState(z=tuple(map(jnp.asarray, z)), dual=tuple(map(jnp.asarray, dual))) \
        if kind == "admm" else None
    jparams = {"net": _jparams(jnet), "coeffs": {k: jnp.asarray(v) for k, v in coeffs.items()}}
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jparams, jnp.asarray(colloc), jadmm_state, None)
    params = {"net": params_from_jax(jnet, CPU),
              "coeffs": {k: torch.from_numpy(v) for k, v in coeffs.items()}}
    leaves = [t.requires_grad_(True) for layer in params["net"] for t in (layer["W"], layer["b"])]
    tadmm_state = tadmm.ADMMState(z=tuple(map(torch.from_numpy, z)),
                                  dual=tuple(map(torch.from_numpy, dual))) if kind == "admm" else None
    tloss, taux = ttrainer.make_loss_fn(tp)(params, torch.from_numpy(colloc), tadmm_state)
    tgrad = torch.autograd.grad(tloss, leaves)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    jflat = [jgrad["net"][i][k] for i in range(len(EULER_SMALL) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(tgrad, jflat)):
        _close_grad(g.numpy(), w, f"leaf {i}")


def test_euler_data_field_weights_only_for_euler():
    tp = _port_euler_problem({"model.layers": EULER_SMALL,
                              "loss.data_field_weights": (1.0, 2.0)})
    with pytest.raises(ValueError, match="3 entries"):
        ttrainer.make_loss_fn(tp)


def _fixture_state(z):
    layers = tuple(int(w) for w in z["layers"])
    net = _net_from_flat(z["params_0"], layers)
    zeros = [{k: np.zeros_like(v) for k, v in layer.items()} for layer in net]
    coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.zeros(1, np.float32)}
    tree = {"params": {"net": net, "coeffs": coeffs}, "count": 0,
            "mu": {"net": zeros, "coeffs": {k: np.zeros_like(v) for k, v in coeffs.items()}},
            "nu": {"net": zeros, "coeffs": {k: np.zeros_like(v) for k, v in coeffs.items()}},
            "z": tuple(v.reshape(-1, 1) for v in z["z_0"]),
            "dual": tuple(v.reshape(-1, 1) for v in z["dual_0"]),
            "colloc": z["colloc_0"], "epoch": 0}
    return layers, train_state_from_jax(tree, CPU, key=int(z["seed"]))


def test_euler_step_replays_the_fixture():
    """euler_admm at its full trunk from JAX's initial state (the fixture):
    the loss and every gradient leaf at that state, then STEPS plain Adam
    epochs each fed JAX's next batch: the metrics, z / dual of each component
    (they follow the params through the residual at the new points), the
    params after the first step (Adam's first update is
    lr g / (|g| + eps), so an entry whose gradient is within rounding of zero
    may take the other sign: atol 2 lr) and each leaf's sum and sum of
    squares after every step."""
    with np.load(FIXTURE) as z:
        z = dict(z)
    layers, state = _fixture_state(z)
    tp = _port_euler_problem({})
    assert tp.spec.layers == layers
    np.testing.assert_array_equal(tp.x_data.numpy(), z["x_data"])
    loss_fn = ttrainer.make_loss_fn(tp)
    params = {"net": [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                      for layer in state.params["net"]], "coeffs": state.params["coeffs"]}
    leaves = [t for layer in params["net"] for t in (layer["W"], layer["b"])]
    loss, _ = loss_fn(params, state.colloc, state.admm)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(z["loss_0"]), rtol=1e-4)
    for i, (g, w) in enumerate(zip(grads, _flat_leaves(z["grad_0"], layers))):
        _close_grad(g.numpy(), w, f"grad leaf {i}")
    step = ttrainer.make_adam_step(tp, get_preset("euler_admm").optimizer.learning_rate)
    rho = tp.exp.loss.rho
    steps = max(int(k.split("_")[1]) for k in z if k.startswith("metrics_"))
    for k in range(1, steps + 1):
        state, metrics = step(state, new_colloc=torch.from_numpy(z[f"colloc_{k}"]))
        want = z[f"metrics_{k}"]
        for i, name in enumerate(METRIC_KEYS):
            np.testing.assert_allclose(float(metrics[name]), float(want[i]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {k} {name}")
        # rtol 1e-4 (the step's), and atol 2e-6 max|z| for z; dual + rho (r - z)
        # cancels terms of size rho max|z|: the dual within 1e-6 of that
        scale = {"z": float(np.abs(z[f"z_{k}"]).max()),
                 "dual": 0.5 * rho * float(np.abs(z[f"z_{k}"]).max())}
        for part in ("z", "dual"):
            got = np.stack([v.numpy().ravel() for v in getattr(state.admm, part)])
            np.testing.assert_allclose(got, z[f"{part}_{k}"], rtol=1e-4, atol=2e-6 * scale[part],
                                       err_msg=f"step {k} {part}")
        got = [v.numpy().astype(np.float64) for layer in state.params["net"]
               for v in (layer["W"], layer["b"])]
        sums = np.asarray([(v.sum(), (v * v).sum()) for v in got])
        np.testing.assert_allclose(sums, z[f"sums_{k}"], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(z[f"sums_{k}"]).max()))
        if k == 1:
            for i, (g, w) in enumerate(zip(got, _flat_leaves(z["params_1"], layers))):
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-3, err_msg=f"params_1 leaf {i}")


def test_euler_trainer_runs_and_checkpoints(tmp_path):
    """A few Adam chunks of euler_admm_tuned (curriculum, field weights) at a
    small net on the CPU: finite per-field rel-L2 on the native grid, a tuple
    ADMM state, and a checkpoint that restores it."""
    exp = override(get_preset("euler_admm_tuned"), {
        "model.layers": EULER_SMALL, "sampling.n_f": 64, "train.epochs": 6, "train.chunk": 3,
        "train.out_dir": str(tmp_path), "train.log_every": 3})
    trainer = ttrainer.Trainer(exp, device="cpu")
    state, summary = trainer.train()
    assert sorted(k for k in summary if k.startswith("rel_l2")) == \
        ["rel_l2_E", "rel_l2_rho", "rel_l2_u"]
    assert all(np.isfinite(summary[f"rel_l2_{f}"]) for f in FIELDS)
    assert summary["truth"] == "native" and summary["epochs"] == 6
    assert isinstance(state.admm.z, tuple) and len(state.admm.z) == 3
    back = ckpt_io.load_checkpoint(str(tmp_path / "euler_admm_tuned_final.ckpt"), "cpu")
    for a, b in zip(back.admm.z + back.admm.dual, state.admm.z + state.admm.dual):
        assert torch.equal(a, b)
    # the curriculum keeps the batch after step 5 below 5% of the t-range
    t_max = ttrainer._curriculum_bounds(trainer.problem, 5)[1][1]
    assert float(state.colloc[:, 1].max()) < float(t_max) < float(trainer.problem.ub[1])


# -- prediction and serving -----------------------------------------------------

def test_euler_predict_fields_match_the_fixture():
    """predict_fields of the Euler problem at the fixture's initial trunk
    against JAX's outputs on a sample of the grid (the card holds all 47,100
    points), and euler_fields on the bare net the same pass."""
    with np.load(FIXTURE) as z:
        z = dict(z)
    layers = tuple(int(w) for w in z["layers"])
    net = params_from_jax(_net_from_flat(z["params_0"], layers), CPU)
    tp = _port_euler_problem({})
    idx = np.random.default_rng(80).choice(z["predict_x"].shape[0], 2_000, replace=False)
    x = torch.from_numpy(z["predict_x"][idx])
    params = {"net": net, "coeffs": {"lambda1": torch.ones(1), "lambda2": torch.zeros(1)}}
    out = predict_fields(tp, params, x)
    assert sorted(out) == sorted(("rho", "u", "E", "f1", "f2", "f3"))
    for name in FIELDS:
        _close(out[name].numpy().ravel(), z[f"predict_{name}"][idx], "field", name)
    for name in RES:
        want = z[f"predict_{name}"]
        np.testing.assert_allclose(out[name].numpy().ravel(), want[idx], rtol=1e-5,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    bare = euler_fields(tp.spec, net, x, 1.4)
    for name in out:
        assert torch.equal(bare[name], out[name])


def test_euler_artifact_round_trip(tmp_path):
    """export_predict of an Euler net, then ServedModel.predict on the CPU:
    the six outputs of euler_fields, the artifact's meta naming the PDE, and
    the params file carrying pde and gamma."""
    spec = MLPSpec(layers=EULER_SMALL, lb=(0.0, 0.002032), ub=(1.0, 0.2008228))
    jnet = numpy_params(EULER_SMALL, 81)
    path = export_predict(spec, jnet, str(tmp_path / "art"), 0.0, 0.0, experiment="euler_admm",
                          pde="euler", gamma=1.4)
    served = ServedModel(path, device="cpu")
    assert served.pde == "euler" and served.fields == ["E", "f1", "f2", "f3", "rho", "u"]
    assert served.meta["provenance"]["config"]["gamma"] == 1.4
    x = np.random.default_rng(82).uniform((0.0, 0.002032), (1.0, 0.2008228),
                                          (37, 2)).astype(np.float32)
    got = served.predict(x)
    want = euler_fields(spec, params_from_jax(jnet, CPU), torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name].numpy())
    p = str(tmp_path / "p.npz")
    save_params_npz(p, spec, jnet, 0.0, 0.0, pde="euler", gamma=1.3)
    from pinns_tpu_torch.interop import load_params_npz

    loaded = load_params_npz(p)
    assert loaded["pde"] == "euler" and loaded["gamma"] == 1.3
    with pytest.raises(ValueError, match="unknown pde"):
        export_predict(spec, jnet, str(tmp_path / "bad"), 0.0, 0.0, pde="maxwell")


@pytest.mark.parametrize("preset", ["euler_admm", "euler_admm_tuned"])
def test_cli_trains_the_euler_presets_on_cpu(tmp_path, preset):
    """``train --preset euler_admm[_tuned]`` runs (a small net, a few epochs)
    and prints the per-field summary against the native grid."""
    import json
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "pinns_tpu_torch", "train", "--preset", preset, "--epochs", "3",
         "--chunk", "2", "--device", "cpu", "--set", f"model.layers={EULER_SMALL}",
         "--set", "sampling.n_f=64", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(summary) == ["epochs", "lambda1", "lambda2", "rel_l2_E", "rel_l2_rho",
                               "rel_l2_u", "truth"]
    assert summary["epochs"] == 3 and summary["truth"] == "native"
    assert (tmp_path / f"{preset}_final.ckpt").exists()
