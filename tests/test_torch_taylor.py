"""Port parity: pinns_tpu_torch.ops.taylor (and its CUDA kernel's wrapper)
against pinns_tpu.ops.taylor.mlp_taylor_2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.taylor import mlp_taylor_2 as jax_taylor_2
from pinns_tpu_torch.interop import load_params_npz, params_from_jax
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import mlp_taylor_2
from torch_port_util import (
    FIXTURE,
    LB,
    SMALL,
    UB,
    assert_close,
    numpy_params,
    numpy_points,
)

CPU = torch.device("cpu")
STREAMS = ("u", "u_x", "u_t", "u_xx")


def _fixture_net():
    loaded = load_params_npz(FIXTURE)
    return loaded["spec"], loaded["params"]


def _small_net():
    return MLPSpec(layers=SMALL, lb=LB, ub=UB), numpy_params(SMALL, seed=10)


@pytest.mark.parametrize("net", [_small_net, _fixture_net], ids=["16x3", "20x8-trained"])
def test_mlp_taylor_2_matches_jax(net):
    spec, jparams = net()
    x = numpy_points(333, seed=11)
    got = mlp_taylor_2(spec, params_from_jax(jparams, CPU), torch.from_numpy(x))
    jspec = JSpec(layers=spec.layers, lb=spec.lb, ub=spec.ub)
    want = jax_taylor_2(
        jspec, [{k: jnp.asarray(v) for k, v in p.items()} for p in jparams], jnp.asarray(x)
    )
    for name, g, w in zip(STREAMS, got, want):
        assert g.shape == (333, 1) and g.dtype == torch.float32
        assert_close(name, g.numpy(), np.asarray(w))


def test_cpu_tensor_never_launches():
    spec, jparams = _small_net()
    before = k_taylor2.LAUNCHES
    mlp_taylor_2(spec, params_from_jax(jparams, CPU), torch.from_numpy(numpy_points(5, 0)))
    assert k_taylor2.LAUNCHES == before


@pytest.mark.parametrize(
    "extra", [{"compute_dtype": torch.bfloat16}, {"keep_streams": ("xx",)}],
    ids=["compute_dtype", "keep_streams"],
)
def test_mixed_stream_policy_raises(extra):
    """The policy computes on the CPU (keep_streams without compute_dtype is
    plain float32, as in JAX); the kernel wrapper, K6 for a mixed spec and K1
    otherwise, raises on a CPU tensor instead of falling back."""
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB, **extra)
    params = params_from_jax(numpy_params(SMALL, seed=0), CPU)
    x = torch.from_numpy(numpy_points(7, seed=1))
    got = mlp_taylor_2(spec, params, x)
    assert all(bool(torch.isfinite(t).all()) and t.dtype == torch.float32 for t in got)
    before = (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES)
    if not spec.mixed:
        plain = mlp_taylor_2(MLPSpec(layers=SMALL, lb=LB, ub=UB), params, x)
        assert all(torch.equal(g, w) for g, w in zip(got, plain))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_taylor2.taylor2(spec, params, x)
    assert (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES) == before


@pytest.mark.parametrize("width", [1, 20, 64, 200, 256])
def test_launch_config_fits_the_card(width):
    layers = (2,) + (width,) * 8 + (1,)
    tile, threads = k_taylor2.launch_config(layers)
    assert tile >= 4 and tile % 4 == 0
    assert 32 <= threads <= 640 and threads % 32 == 0
    # two ping-pong buffers of four streams stay within half an SM's shared memory
    assert k_taylor2.smem_bytes(layers, tile) <= 112 * 1024


def test_launch_config_rejects_wide_nets():
    with pytest.raises(ValueError, match="256"):
        k_taylor2.launch_config((2, 300, 1))
