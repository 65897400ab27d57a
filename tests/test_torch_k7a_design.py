"""K7a's two designs and K8s (c)'s wrapper, on the CPU: which design a net
takes (by its widths and paths), each design's launches a call and scratch
layout, the narrow design's backward order written out in PyTorch against
the plain reverse mode and against JAX's VJP of ``mlp_taylor_1``, and the
member reduction's refusals.

Tolerances: the narrow twin against the plain reverse mode 1e-12 of each
leaf's max in float64 and 1e-5 in float32 (the same sums in another order);
against JAX rtol 1e-4 / atol 1e-5 max|g| per leaf (float32 in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.taylor import mlp_taylor_1 as jax_taylor_1
from pinns_tpu_torch.interop import params_from_jax
from pinns_tpu_torch.models.mlp import MLPSpec, input_scale, normalize_inputs
from pinns_tpu_torch.ops.kernels import ensemble as k_ens
from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
from torch_port_util import LB, UB, numpy_params, numpy_points

CPU = torch.device("cpu")
EULER = (2,) + (200,) * 5 + (3,)
NARROW = (2,) + (20,) * 8 + (1,)

DESIGN_CASES = [(NARROW, 0, "narrow"), ((2, 20, 20, 20, 3), 0, "narrow"),
                ((2, 32, 32, 3), 0, "narrow"), ((2, 33, 3), 0, "wide"), (EULER, 0, "wide"),
                ((2, 20, 20, 3), 2, "wide"), (EULER, 2, "wide"), ((2, 3), 0, "narrow")]


@pytest.mark.parametrize("layers,paths,want", DESIGN_CASES,
                         ids=[f"{'-'.join(map(str, c[0]))}-k{c[1]}" for c in DESIGN_CASES])
def test_k7a_design_by_width_and_paths(layers, paths, want):
    """Every width at most 32 and no paths: the narrow design; a wider net or
    any path net (whose input is 2 + K wide): the wide one. The plan follows
    the widths, never a switch."""
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, n_paths=paths, path_degree=2,
                   path_sharpness=12.0)
    assert k_taylor1.default_design(spec.widths) == want
    for backward in (False, True):
        plan = k_taylor1.taylor1_plan(spec.widths, 1_000, backward, spec.n_path_params)
        assert plan.design == want


LAUNCH_CASES = [(EULER, 0, n, b) for n in (1, 1_000, 65_536) for b in (False, True)] + \
    [(EULER, 2, n, b) for n in (1_000, 16_000) for b in (False, True)] + \
    [(NARROW, 0, n, b) for n in (1, 16_000, 25_600) for b in (False, True)]


@pytest.mark.parametrize("layers,paths,n,backward", LAUNCH_CASES,
                         ids=[f"{max(c[0])}w-k{c[1]}-n{c[2]}-{'bwd' if c[3] else 'fwd'}"
                              for c in LAUNCH_CASES])
def test_k7a_launches_a_call(layers, paths, n, backward):
    """The wide design at the Euler trunk: 7 launches forward (the input
    pass, five hidden layers with the rule in their epilogue, the head's
    three streams), 14 backward and 15 with paths; the narrow design 1 and
    2."""
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, n_paths=paths, path_degree=2,
                   path_sharpness=12.0)
    plan = k_taylor1.taylor1_plan(spec.widths, n, backward, spec.n_path_params)
    if plan.design == "narrow":
        assert plan.launches == (2 if backward else 1)
    else:
        assert plan.launches == ((15 if paths else 14) if backward else 7)
        assert plan.launches <= ((16 if paths else 15) if backward else 7)


SCRATCH_CASES = [(layers, n) for layers in ((2, 20, 20, 20, 3), NARROW, (2, 4, 3))
                 for n in (1, 37, 1_000, 17_000, 25_600)]


@pytest.mark.parametrize("layers,n", SCRATCH_CASES,
                         ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}" for c in SCRATCH_CASES])
def test_k7a_narrow_plan_fits_its_kernel(layers, n):
    """The narrow plans: a forward block of at most 128 points and 640
    threads whose two three-stream buffers fit 112 KB, one block a tile; a
    backward of tiles of at most 64 points whose three buffer triples fit
    200 KB, on at most 264 blocks, its scratch the blocks' partials and
    kept hidden outputs, each part on 16 bytes; no scratch forward."""
    wmax = max(layers)
    fwd = k_taylor1.taylor1_plan(layers, n)
    assert fwd.tile % 4 == 0 and fwd.tile <= 128
    assert 2 * 3 * wmax * (fwd.tile + 4) * 4 <= 112 * 1024
    assert fwd.threads % 32 == 0 and 32 <= fwd.threads <= 640
    assert fwd.grid == -(-n // fwd.tile) and fwd.scratch_floats == 0
    bwd = k_taylor1.taylor1_plan(layers, n, True)
    assert bwd.tile % 4 == 0 and bwd.tile <= 64
    assert 3 * 3 * wmax * (bwd.tile + 4) * 4 <= 200 * 1024
    assert 1 <= bwd.grid <= min(264, -(-n // bwd.tile))
    n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    assert bwd.parts == (-(-bwd.grid * n_params // 4) * 4,
                         -(-bwd.grid * (len(layers) - 2) * 3 * wmax * bwd.tile // 4) * 4)
    assert bwd.scratch_floats == sum(bwd.parts)


@pytest.mark.parametrize("layers,paths,design", [(EULER, 0, "narrow"),
                                                 ((2, 20, 20, 3), 2, "narrow"),
                                                 ((2, 20, 3), 0, "tiled")])
def test_k7a_refuses_a_design_the_net_cannot_take(layers, paths, design):
    """The narrow design only where the widths allow it; no unknown design."""
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, n_paths=paths, path_degree=2,
                   path_sharpness=12.0)
    with pytest.raises(ValueError, match="design"):
        k_taylor1.taylor1_plan(spec.widths, 100, design=design)


def _narrow_order(spec, params, x, cot):
    """The gradient as csrc/taylor1.cu's narrow backward sums it: the points
    cut into the plan's tiles (padded points at (0, 0), zero cotangents),
    tile t on block t mod grid; per tile the forward with each hidden layer's
    output streams kept, then per layer, head first, dW = sum over the three
    streams of X_s^T G_s and db = the value adjoints' sum, added into the
    block's partials in tile order; the rule's adjoint at the kept outputs,
    d1 gh - 2 s (ghx hx + ght ht); the blocks' partials summed in block
    order."""
    plan = k_taylor1.taylor1_plan(spec.widths, x.shape[0], backward=True)
    assert plan.design == "narrow"
    dtype, n, T = spec.dtype, x.shape[0], plan.tile
    scale = input_scale(spec, x.device)
    partials = [None] * plan.grid
    for tix in range(-(-n // T)):
        xt = torch.zeros((T, 2), dtype=dtype)
        gt = [torch.zeros((T, spec.out_dim), dtype=dtype) for _ in range(3)]
        m = min(T, n - tix * T)
        xt[:m] = x[tix * T:tix * T + m]
        for g, c in zip(gt, cot):
            g[:m] = c[tix * T:tix * T + m]
        h = normalize_inputs(spec, xt)
        hx, ht = torch.zeros_like(h), torch.zeros_like(h)
        hx[:, 0], ht[:, 1] = scale[0], scale[1]
        X = [(h, hx, ht)]
        for layer in params[:-1]:
            a = X[-1][0] @ layer["W"] + layer["b"]
            ax, at = X[-1][1] @ layer["W"], X[-1][2] @ layer["W"]
            s = torch.tanh(a)
            d1 = 1.0 - s * s
            X.append((s, d1 * ax, d1 * at))
        G, grads = gt, [None] * (2 * len(params))
        for l in range(len(params) - 1, -1, -1):
            grads[2 * l] = sum(X[l][s].T @ G[s] for s in range(3))
            grads[2 * l + 1] = G[0].sum(dim=0, keepdim=True)
            if l > 0:
                gh = [g @ params[l]["W"].T for g in G]
                s, hx_l, ht_l = X[l]
                d1 = 1.0 - s * s
                G = (d1 * gh[0] - 2.0 * s * (gh[1] * hx_l + gh[2] * ht_l), gh[1] * d1,
                     gh[2] * d1)
        b = tix % plan.grid
        partials[b] = grads if partials[b] is None else [
            p + g for p, g in zip(partials[b], grads)]
    out = [torch.zeros_like(g, dtype=torch.float64) for g in partials[0]]
    for part in partials:
        if part is not None:
            out = [o + p.double() for o, p in zip(out, part)]
    return [o.to(dtype) for o in out]


NARROW_ORDER_CASES = [(layers, n, dtype) for layers, n in
                      (((2, 16, 16, 3), 1), ((2, 16, 16, 3), 37), ((2, 16, 16, 3), 300),
                       ((2, 20, 20, 20, 3), 129), ((2, 3), 70), ((2, 4, 3), 17_000))
                      for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize(
    "layers,n,dtype", NARROW_ORDER_CASES,
    ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}-{str(c[2])[6:]}" for c in NARROW_ORDER_CASES])
def test_k7a_narrow_order_matches_the_plain_reverse_mode(layers, n, dtype):
    """The narrow backward's tiles, blocks and order (17,000 points take more
    tiles than blocks) against taylor1_backward_reference."""
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dtype)
    params = [{k: torch.tensor(v, dtype=dtype) for k, v in layer.items()}
              for layer in numpy_params(layers, 71)]
    x = torch.tensor(numpy_points(n, 72), dtype=dtype)
    rng = np.random.default_rng(73)
    cot = [torch.tensor(rng.standard_normal((n, layers[-1])) / n, dtype=dtype) for _ in range(3)]
    got = _narrow_order(spec, params, x, cot)
    want = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()), err_msg=f"leaf {i}")


@pytest.mark.parametrize("layers", [(2, 16, 16, 3), (2, 20, 20, 20, 3)])
def test_k7a_narrow_order_matches_jax(layers):
    """The narrow backward's order against JAX's VJP of mlp_taylor_1 on the
    same numpy inputs."""
    n = 200
    jnet = numpy_params(layers, 74)
    x = numpy_points(n, 75)
    rng = np.random.default_rng(76)
    cot = [rng.standard_normal((n, layers[-1])).astype(np.float32) for _ in range(3)]
    jspec = JSpec(layers=layers, lb=LB, ub=UB)
    jparams = tuple({k: jnp.asarray(v) for k, v in layer.items()} for layer in jnet)
    _, vjp = jax.vjp(lambda p: jax_taylor_1(jspec, p, jnp.asarray(x)), jparams)
    (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cot))
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    got = _narrow_order(spec, params_from_jax(jnet, CPU), torch.from_numpy(x),
                        [torch.from_numpy(c) for c in cot])
    want = [np.asarray(jgrad[i][k]) for i in range(len(layers) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


K8S_REFUSALS = [
    ("cpu", lambda: (torch.zeros(3, 5, 2), None), "CUDA"),
    ("cpu_dx", lambda: (torch.zeros(3, 5, 2), torch.zeros(3, 5, 1)), "CUDA"),
    ("float64", lambda: (torch.zeros(3, 5, 2, dtype=torch.float64), None), "float32"),
    ("two_dims", lambda: (torch.zeros(15, 2), None), "float32"),
    ("strided", lambda: (torch.zeros(3, 2, 5).transpose(1, 2), None), "contiguous"),
    ("members", lambda: (torch.zeros(3, 5, 2), torch.zeros(4, 5, 1)), "dx is"),
    ("points", lambda: (torch.zeros(3, 5, 2), torch.zeros(3, 6, 1)), "dx is"),
    ("dx_dtype", lambda: (torch.zeros(3, 5, 2), torch.zeros(3, 5, 1, dtype=torch.float16)),
     "float32"),
]


@pytest.mark.parametrize("case,make,match", K8S_REFUSALS, ids=[c[0] for c in K8S_REFUSALS])
def test_k8s_reduction_refuses_what_its_kernel_does_not_take(case, make, match):
    """K8s (c)'s wrapper raises on CPU tensors, other dtypes and layouts, and
    dx stacks of other members or points, before it loads its kernel."""
    values, dx = make()
    count = k_ens.LAUNCHES
    with pytest.raises(ValueError, match=match):
        k_ens.member_stats(values, dx)
    assert k_ens.LAUNCHES == count


def test_k8s_reference_on_the_cpu():
    """The plain version the CPU path takes: mean, population std and
    |mean dx| over the members."""
    rng = np.random.default_rng(77)
    v = rng.standard_normal((5, 7, 3))
    d = rng.standard_normal((5, 7, 2))
    mean, std, dx = k_ens.member_stats_reference(torch.from_numpy(v), torch.from_numpy(d))
    np.testing.assert_allclose(mean.numpy(), v.mean(0), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), v.std(0), rtol=1e-12)
    np.testing.assert_allclose(dx.numpy(), np.abs(d.mean(0)), rtol=1e-12)
