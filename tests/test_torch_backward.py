"""The plain versions of the hand-written backward kernels, held against
torch.autograd, and the CPU-side behaviour of the kernel wrappers.

- K5's backward (``ops/kernels/mlp_forward.py::mlp_backward_reference``, the
  algorithm of ``csrc/mlp_forward.cu``) against autograd through
  ``mlp_apply_reference``;
- K2 (``ops/kernels/taylor2.py::taylor2_backward_reference``, the algorithm
  of ``csrc/taylor2_backward.cu``) against autograd through
  ``mlp_taylor_2_reference``, for arbitrary stream cotangents.

Both in float64 to 1e-10 relative (per leaf, of its max): the same products
summed in other orders. Inputs come from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, mlp_apply, mlp_apply_reference
from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import mlp_taylor_2, mlp_taylor_2_reference
from torch_port_util import LB, UB, NARROW, numpy_params, numpy_points

NETS = [(2, 8, 8, 1), (2, 10, 10, 10, 3), (2, 5, 1)]


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
    # an embedded spec is not the model K5 computes (as the TPU kernel refused it)
    fourier = MLPSpec(layers=(2, 8, 1), lb=LB, ub=UB)
    object.__setattr__(fourier, "fourier", ((1.0, 2.0),))
    with pytest.raises(ValueError, match="Fourier"):
        k_mlp.mlp_forward(fourier, params[:1] + params[-1:], x)


def test_launch_configs_fit_the_card():
    """Tiles, threads and grids of K5 and K2 at the presets' widths: within
    the kernels' launch bounds and the H100's 227 KB of shared memory a block."""
    wide = (2,) + (200,) * 8 + (1,)
    assert k_mlp.forward_config(NARROW) == (128, 640)
    assert k_mlp.forward_config(wide) == (64, 640)
    for layers in (NARROW, wide, (2, 256, 256, 3)):
        tile, threads = k_mlp.forward_config(layers)
        assert tile % 4 == 0 and threads % 32 == 0 and threads <= 640
        assert k_mlp.smem_bytes(layers, tile, 2) <= 227 * 1024
        tile, grid = k_mlp.backward_config(layers, 100_000)
        assert grid == k_mlp.MAX_GRID and k_mlp.smem_bytes(layers, tile, 3) <= 227 * 1024
        tile, grid = k_taylor2.backward_config(layers, 1000)
        assert tile % 4 == 0 and grid == -(-1000 // tile)
        assert k_taylor2.backward_smem_bytes(layers, tile) <= 227 * 1024
    assert k_mlp.backward_config(NARROW, 100) == (64, 2)
    assert k_taylor2.backward_config(NARROW, 10_456) == (64, 164)


def test_split_grad_and_check_call():
    spec, params, x, _ = _case((2, 4, 3, 1), seed=23, dtype=torch.float32)
    leaves = [t for layer in params for t in (layer["W"], layer["b"])]
    flat = k_taylor2.pack_params(params)
    for g, t in zip(k_taylor2.split_grad(flat, leaves), leaves):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
    bad = dataclasses.replace(spec, layers=(2, 4, 4, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_taylor2.check_call("k", bad, params, x)
