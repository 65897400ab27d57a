"""The plain versions of the hand-written backward kernels, held against
torch.autograd, and the CPU-side behaviour of the kernel wrappers.

- K5's backward (``ops/kernels/mlp_forward.py::mlp_backward_reference``, the
  algorithm of ``csrc/mlp_forward.cu``) against autograd through
  ``mlp_apply_reference``;
- K2 (``ops/kernels/taylor2.py::taylor2_backward_reference``, the algorithm
  of ``csrc/taylor2_backward.cu``) against autograd through
  ``mlp_taylor_2_reference``, for arbitrary stream cotangents;
- K2's layout and summation order (stacked stream rows, padding, the bias
  folded into the products, split-K partials over ``backward_plan``),
  written out in PyTorch, against ``taylor2_backward_reference``;
- the wide K5's layout and summation order (padding, the bias's indicator
  column, split-K partials over ``mlp_backward_plan``, per-tile db), written
  out in PyTorch, against ``mlp_apply_reference`` and
  ``mlp_backward_reference``, and its plans.

Both in float64 to 1e-10 relative (per leaf, of its max): the same products
summed in other orders. Inputs come from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pinns_tpu_torch.models.mlp import (MLPSpec, input_scale, mlp_apply, mlp_apply_reference,
                                        normalize_inputs)
from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import (POLICY_STREAMS, _StreamPolicy, mlp_taylor_2,
                                        mlp_taylor_2_reference)
from torch_port_util import LB, UB, NARROW, numpy_params, numpy_points

NETS = [(2, 8, 8, 1), (2, 10, 10, 10, 3), (2, 5, 1)]
EULER = (2,) + (200,) * 5 + (3,)  # the Euler slices' trunk


def _case(layers, seed, dtype=torch.float64, n=37):
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dtype)
    params = [{k: torch.tensor(v, dtype=dtype) for k, v in layer.items()}
              for layer in numpy_params(layers, seed)]
    x = torch.tensor(numpy_points(n, seed + 1), dtype=dtype)
    rng = np.random.default_rng(seed + 2)
    cot = [torch.tensor(rng.standard_normal((n, layers[-1])), dtype=dtype) for _ in range(4)]
    return spec, params, x, cot


def _autograd(fn, params, cot):
    leaves = [t.requires_grad_(True) for layer in params for t in (layer["W"], layer["b"])]
    outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum(torch.sum(o * c) for o, c in zip(outs, cot))
    return torch.autograd.grad(total, leaves)


def _assert_leaves(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(w.abs().max()), err_msg=f"leaf {i}")


@pytest.mark.parametrize("layers", NETS)
def test_mlp_backward_reference_matches_autograd(layers):
    spec, params, x, cot = _case(layers, seed=11)
    want = _autograd(lambda: mlp_apply_reference(spec, params, x), params, cot[:1])
    got = k_mlp.mlp_backward_reference(spec, [{k: v.detach() for k, v in p.items()}
                                              for p in params], x, cot[0])
    _assert_leaves(got, want)


@pytest.mark.parametrize("layers", NETS)
def test_taylor2_backward_reference_matches_autograd(layers):
    spec, params, x, cot = _case(layers, seed=13)
    want = _autograd(lambda: mlp_taylor_2_reference(spec, params, x), params, cot)
    got = k_taylor2.taylor2_backward_reference(
        spec, [{k: v.detach() for k, v in p.items()} for p in params], x, cot)
    _assert_leaves(got, want)


def test_cpu_dispatch_takes_the_plain_versions():
    """On CPU tensors mlp_apply and mlp_taylor_2 are the plain versions, with
    their autograd, and no kernel is launched."""
    spec, params, x, cot = _case((2, 8, 8, 1), seed=17, dtype=torch.float32)
    before = (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES, k_taylor2.LAUNCHES,
              k_taylor2.BACKWARD_LAUNCHES)
    got = _autograd(lambda: mlp_apply(spec, params, x), params, cot[:1])
    want = _autograd(lambda: mlp_apply_reference(spec, params, x), params, cot[:1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got = _autograd(lambda: mlp_taylor_2(spec, params, x), params, cot)
    want = _autograd(lambda: mlp_taylor_2_reference(spec, params, x), params, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES, k_taylor2.LAUNCHES,
            k_taylor2.BACKWARD_LAUNCHES) == before


def test_kernel_wrappers_raise_on_cpu_tensors():
    spec, params, x, cot = _case((2, 8, 8, 1), seed=19, dtype=torch.float32)
    before = (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES, k_taylor2.BACKWARD_LAUNCHES)
    for call in (lambda: k_mlp.mlp_forward(spec, params, x),
                 lambda: k_mlp.mlp_backward(spec, params, x, cot[0]),
                 lambda: k_mlp.mlp_apply_kernel(spec, params, x),
                 lambda: k_taylor2.taylor2_backward(spec, params, x, cot),
                 lambda: k_taylor2.mlp_taylor2_kernel(spec, params, x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES, k_taylor2.BACKWARD_LAUNCHES) == before
    # a Fourier spec (which the TPU kernel refused) is K5's since slice
    # 2b-iii, on its wide design at any width: on a CPU tensor it raises for
    # the device, and the widths are checked against the embedded input
    fourier = MLPSpec(layers=(2, 8, 1), lb=LB, ub=UB, fourier=((1.0, 2.0),))
    assert k_mlp.design(fourier.widths) == "wide" and fourier.widths[0] == 4
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_mlp.mlp_forward(fourier, params[:1] + params[-1:], x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_mlp.mlp_backward(fourier, params[:1] + params[-1:], x, cot[0])
    assert (k_mlp.LAUNCHES, k_mlp.BACKWARD_LAUNCHES) == before[:2]


def test_launch_configs_fit_the_card():
    """Tiles, threads and grids of K5, and K2's plan, at the presets' widths:
    within the kernels' launch bounds and the H100's 227 KB of shared memory a
    block; K2's splits cover its 4 n_pad stacked rows exactly, and its scratch
    at 8x200 is the size PERF.md states."""
    wide = (2,) + (200,) * 8 + (1,)
    assert k_mlp.forward_config(NARROW) == (128, 640)
    # K5 above width 32 takes the wide design (its plan: test_wide_plan_fits_its_layout)
    assert k_mlp.design(NARROW) == "narrow" and k_mlp.design(wide) == "wide"
    assert k_mlp.design(EULER) == "wide" and k_mlp.design((2, 32, 32, 1)) == "narrow"
    assert [k_mlp.mlp_backward_plan(wide, n).tile for n in (100, 2_000, 8_192)] == [32, 32, 128]
    tile = k_taylor2.GEMM_TILE
    assert k_taylor2.GEMM_THREADS % 32 == 0 and k_taylor2.GEMM_THREADS <= 1024
    assert tile * tile == k_taylor2.GEMM_THREADS * 8 * 8  # an 8 x 8 register tile a thread
    assert k_taylor2.GEMM_SMEM <= 48 * 1024  # static shared memory
    for layers in (NARROW, (2, 32, 32, 3)):  # the narrow K5
        tile_k5, threads = k_mlp.forward_config(layers)
        assert tile_k5 % 4 == 0 and threads % 32 == 0 and threads <= 640
        assert k_mlp.smem_bytes(layers, tile_k5, 2) <= 227 * 1024
        tile_k5, grid = k_mlp.backward_config(layers, 100_000)
        assert grid == k_mlp.MAX_GRID and k_mlp.smem_bytes(layers, tile_k5, 3) <= 227 * 1024
    for layers in (NARROW, wide, (2, 256, 256, 3)):
        for n in (1, 37, 1000, 8_192, 10_456, 65_536, 1_048_576):
            plan = k_taylor2.backward_plan(layers, n)
            rows = 4 * plan.n_pad
            assert plan.n_pad % tile == 0 and n <= plan.n_pad < n + tile
            assert plan.split_rows % tile == 0
            assert plan.split_rows <= k_taylor2.MAX_SPLIT_TILES * tile
            assert plan.splits <= max(k_taylor2.SPLIT_WARPS, rows // plan.split_rows)
            assert (plan.splits - 1) * plan.split_rows < rows <= plan.splits * plan.split_rows
            parts = dataclasses.astuple(plan)[3:]  # the scratch's parts, each on 16 bytes
            assert all(part % 4 == 0 for part in parts) and sum(parts) == plan.scratch_floats
    assert k_mlp.backward_config(NARROW, 100) == (64, 2)
    shape = lambda p: (p.n_pad, p.split_rows, p.splits)  # noqa: E731
    assert shape(k_taylor2.backward_plan(NARROW, 10_456)) == (10_496, 128, 328)
    assert shape(k_taylor2.backward_plan(wide, 8_192)) == (8_192, 512, 64)
    assert shape(k_taylor2.backward_plan(wide, 65_536)) == (65_536, 1_024, 256)
    assert k_taylor2.backward_plan(wide, 8_192).scratch_bytes == 362_572_032
    assert k_taylor2.backward_plan(wide, 8_192, mixed=True).scratch_bytes == 363_700_848
    assert k_taylor2.backward_plan(wide, 65_536).scratch_bytes == 2_611_602_432


# -- K2's layout and order, written out in PyTorch ---------------------------

def _stack(streams, ones):
    """Four (n_pad, d) streams stacked stream-major, with the bias's
    indicator column (1 on value rows) when ``ones``."""
    if ones:
        streams = [torch.cat([s, torch.full_like(s[:, :1], float(i == 0))], dim=1)
                   for i, s in enumerate(streams)]
    return torch.cat(streams, dim=0)


def _kernel_order_grad(spec, params, x, cot):
    """The flat gradient as csrc/taylor2_backward.cu lays it out and sums
    it: the four streams of n_pad points (padded points at (0, 0), zero
    cotangents) stacked into one matrix per layer; the forward as
    H [W; b] with per-stream weights; gH = G W^T with the weights each
    stream's forward dot used; dW = H^T G over the wrapper's split chunks,
    the partials summed in split order; db = the value rows of G summed per
    row tile, then over the tiles."""
    plan = k_taylor2.backward_plan(spec.layers, x.shape[0], spec.mixed)
    pol = _StreamPolicy(spec)
    dtype, n, n_pad = spec.dtype, x.shape[0], plan.n_pad
    xp = torch.zeros((n_pad, 2), dtype=dtype)
    xp[:n] = x
    h = normalize_inputs(spec, xp)
    scale = input_scale(spec, xp.device)
    ex, et = torch.zeros_like(h), torch.zeros_like(h)
    ex[:, 0], et[:, 1] = scale[0], scale[1]
    H = [_stack((h, ex, et, torch.zeros_like(h)), ones=True)]
    saved = []  # (pre-activations, tanh factors) of each hidden layer
    for l, layer in enumerate(params[:-1]):
        P = [H[-1][i * n_pad:(i + 1) * n_pad]
             @ torch.cat([layer["W"] if l == 0 else pol.weight(layer["W"], name), layer["b"]])
             for i, name in enumerate(POLICY_STREAMS)]
        p, px, pt, pxx = (pol.act(v, name, l == 0) for v, name in zip(P, POLICY_STREAMS))
        s = torch.tanh(p)
        sp = 1.0 - s * s
        spp = -2.0 * s * sp
        out = (pol.store(s, "value"), pol.store(sp * px, "deriv"), pol.store(sp * pt, "deriv"),
               pol.store(spp * px * px + sp * pxx, "xx"))
        saved.append((tuple(v.to(dtype) for v in (p, px, pt, pxx)),
                      tuple(v.to(dtype) for v in (s, sp, spp))))
        H.append(_stack([v.to(dtype) for v in out], ones=True))
    pad = lambda g: torch.cat([g, torch.zeros((n_pad - n, g.shape[1]), dtype=dtype)])  # noqa: E731
    G = _stack([pad(g) for g in cot], ones=False)
    grads = [None] * len(params)
    for l in range(len(params) - 1, -1, -1):
        rows = [slice(z * plan.split_rows, (z + 1) * plan.split_rows)
                for z in range(plan.splits)]
        dW = torch.zeros((params[l]["W"].shape), dtype=dtype)
        for r in rows:
            dW = dW + H[l][r, :-1].T @ G[r]
        tile = k_taylor2.GEMM_TILE
        db = sum(G[t:t + tile].sum(dim=0, keepdim=True) for t in range(0, n_pad, tile))
        grads[l] = torch.cat([dW, db])
        if l > 0:
            W = params[l]["W"]
            gH = [G[i * n_pad:(i + 1) * n_pad] @ pol.weight(W, name).T
                  for i, name in enumerate(POLICY_STREAMS)]
            G = _stack(k_taylor2._act_backward(*saved[l - 1], gH), ones=False)
    return torch.cat([g.reshape(-1) for g in grads])


KERNEL_ORDER_CASES = [(layers, n, keep, dtype) for layers in NETS for n in (1, 37, 34 * 128 + 1)
                      for keep in (None, ("xx",)) for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize(
    "layers,n,keep,dtype", KERNEL_ORDER_CASES,
    ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}-{'f32' if c[2] is None else 'keep_xx'}-"
         f"{str(c[3])[6:]}" for c in KERNEL_ORDER_CASES])
def test_kernel_layout_and_order_match_the_plain_backward(layers, n, keep, dtype):
    """K2's stacked, padded, bias-folded, split-K layout (K6's backward's
    under keep {xx}, with per-stream weights) against taylor2_backward_
    reference: 1e-12 of each leaf's max in float64, 1e-5 in float32 (the
    same products summed in another order: at most 3e-15 and 2e-6 here)."""
    mixed = {} if keep is None else {"compute_dtype": "bfloat16", "keep_streams": keep}
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dtype, **mixed)
    params = [{k: torch.tensor(v, dtype=dtype) for k, v in layer.items()}
              for layer in numpy_params(layers, 31)]
    x = torch.tensor(numpy_points(n, 32), dtype=dtype)
    rng = np.random.default_rng(33)
    cot = [torch.tensor(rng.standard_normal((n, layers[-1])) / n, dtype=dtype)
           for _ in range(4)]
    got = _kernel_order_grad(spec, params, x, cot)
    want = k_taylor2.taylor2_backward_reference(spec, params, x, cot)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i, (g, w) in enumerate(zip(k_taylor2.split_grad(got, want), want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()), err_msg=f"leaf {i}")


# -- the wide K5's layout and order, written out in PyTorch ---------------------

def _k5_wide_order(spec, params, x, g_out):
    """u and the gradient as csrc/mlp_forward.cu's wide design lays them out
    and sums them: n_pad points (padded points at (0, 0), zero cotangents);
    every layer input carries the bias's indicator column, so a layer is one
    product H [W; b]; the hidden outputs kept; dW = H^T G over the plan's
    split chunks, the partials summed in split order; db = G summed per
    EW_TILE-point row tile, then over the tiles; gH = G W_l^T over the plan's
    gh_splits chunks of the layer's width (whole 8-deep tiles), summed in
    order; G_l-1 = (1 - H_l^2) gH."""
    plan = k_mlp.mlp_backward_plan(spec.layers, x.shape[0])
    dtype, n, n_pad = spec.dtype, x.shape[0], plan.n_pad
    xp = torch.zeros((n_pad, 2), dtype=dtype)
    xp[:n] = x
    ones = torch.ones((n_pad, 1), dtype=dtype)
    wb = [torch.cat([layer["W"], layer["b"]]) for layer in params]
    H = [torch.cat([normalize_inputs(spec, xp), ones], dim=1)]
    for w in wb[:-1]:
        H.append(torch.cat([torch.tanh(H[-1] @ w), ones], dim=1))
    u = (H[-1] @ wb[-1])[:n]
    G = torch.cat([g_out, torch.zeros((n_pad - n, g_out.shape[1]), dtype=dtype)])
    grads = [None] * (2 * len(params))
    tile = k_mlp.EW_TILE
    for l in range(len(params) - 1, -1, -1):
        dW = torch.zeros_like(params[l]["W"])
        for z in range(plan.splits):
            rows = slice(z * plan.split_rows, (z + 1) * plan.split_rows)
            dW = dW + H[l][rows, :-1].T @ G[rows]
        grads[2 * l] = dW
        grads[2 * l + 1] = sum(G[t:t + tile].sum(dim=0, keepdim=True)
                               for t in range(0, n_pad, tile))
        if l > 0:
            dout = G.shape[1]
            step = -(-dout // (8 * plan.gh_splits)) * 8
            gh = sum(G[:, k:k + step] @ params[l]["W"][:, k:k + step].T
                     for k in range(0, dout, step))
            G = (1.0 - H[l][:, :-1] * H[l][:, :-1]) * gh
    return u, grads


K5_WIDE_ORDER_CASES = [(layers, n) for layers in NETS + [(2, 40, 40, 3)] for n in (1, 37, 129)]


@pytest.mark.parametrize("layers,n", K5_WIDE_ORDER_CASES,
                         ids=[f"{'-'.join(map(str, c[0]))}-n{c[1]}" for c in K5_WIDE_ORDER_CASES])
def test_k5_wide_layout_and_order_match_the_plain_versions(layers, n):
    """The wide K5's padded, bias-folded, split-K layout against
    mlp_apply_reference and mlp_backward_reference in float64: 1e-10 of each
    leaf's max (the same products summed in other orders)."""
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    params = [{k: torch.tensor(v, dtype=torch.float64) for k, v in layer.items()}
              for layer in numpy_params(layers, 41)]
    x = torch.tensor(numpy_points(n, 42), dtype=torch.float64)
    g = torch.tensor(np.random.default_rng(43).standard_normal((n, layers[-1])) / n,
                     dtype=torch.float64)
    u, got = _k5_wide_order(spec, params, x, g)
    _assert_leaves([u], [mlp_apply_reference(spec, params, x)])
    _assert_leaves(got, k_mlp.mlp_backward_reference(spec, params, x, g))


WIDE_PLAN_CASES = [(layers, n) for layers in (NARROW, (2,) + (200,) * 8 + (1,), EULER)
                   for n in (1, 100, 200, 2_000, 8_192, 65_536)]


@pytest.mark.parametrize("layers,n", WIDE_PLAN_CASES,
                         ids=[f"{len(c[0]) - 2}x{max(c[0])}-out{c[0][-1]}-n{c[1]}"
                              for c in WIDE_PLAN_CASES])
def test_wide_plan_fits_its_layout(layers, n):
    """The wide K5's plans at the presets' widths: the padding is whole row
    tiles, the tile one the kernel instantiates, the splits cover the padded
    rows exactly in chunks of at most 1,024 rows, and the scratch's parts lie
    on 16 bytes and add up to it."""
    for plan in (k_mlp.mlp_forward_plan(layers, n), k_mlp.mlp_backward_plan(layers, n)):
        assert plan.n_pad % k_mlp.EW_TILE == 0 and n <= plan.n_pad < n + k_mlp.EW_TILE
        assert plan.tile in (k_mlp.SMALL_TILE, k_mlp.LARGE_TILE)
        parts = dataclasses.astuple(plan)[5:]
        assert all(part % 4 == 0 for part in parts) and sum(parts) == plan.scratch_floats
    plan = k_mlp.mlp_backward_plan(layers, n)
    assert plan.split_rows % k_mlp.SPLIT_STEP == 0 and plan.split_rows <= 1024
    assert (plan.splits - 1) * plan.split_rows < plan.n_pad <= plan.splits * plan.split_rows
    assert 1 <= plan.gh_splits <= k_mlp.MAX_GH_SPLITS
    assert plan.gh_splits == 1 or plan.tile == k_mlp.SMALL_TILE
    assert k_mlp.mlp_forward_plan(layers, n).tile == plan.tile


def test_wide_plan_at_the_scale_shapes():
    """burgers_scale's 8x200 net: the data term's 100 points on the small
    tile, dW in 32-row chunks and gH in four, 65,536 points on the large
    tile; the scratch at 65,536 points is the size PERF.md states."""
    wide = (2,) + (200,) * 8 + (1,)
    shape = lambda p: (p.tile, p.n_pad, p.split_rows, p.splits, p.gh_splits)  # noqa: E731
    assert shape(k_mlp.mlp_backward_plan(wide, 100)) == (32, 128, 32, 4, 4)
    assert shape(k_mlp.mlp_backward_plan(wide, 2_000)) == (32, 2_048, 256, 8, 1)
    assert shape(k_mlp.mlp_backward_plan(wide, 65_536)) == (128, 65_536, 672, 98, 1)
    assert k_mlp.mlp_backward_plan(wide, 65_536).scratch_bytes == 651_720_784
    assert k_mlp.mlp_forward_plan(wide, 65_536).scratch_bytes == 108_003_328


def test_split_grad_and_check_call():
    spec, params, x, _ = _case((2, 4, 3, 1), seed=23, dtype=torch.float32)
    leaves = [t for layer in params for t in (layer["W"], layer["b"])]
    flat = k_taylor2.pack_params(params)
    for g, t in zip(k_taylor2.split_grad(flat, leaves), leaves):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
    bad = dataclasses.replace(spec, layers=(2, 4, 4, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_taylor2.check_call("k", bad, params, x)
