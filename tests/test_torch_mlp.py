"""Port parity: pinns_tpu_torch.models.mlp + interop against pinns_tpu.models.mlp."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models import mlp as jmlp
from pinns_tpu_torch.interop import (
    load_params_npz,
    params_from_jax,
    params_to_numpy,
    save_params_npz,
)
from pinns_tpu_torch.models.mlp import MLP, MLPSpec, init_mlp, mlp_apply, normalize_inputs
from torch_port_util import LB, NARROW, SMALL, UB, numpy_params, numpy_points

CPU = torch.device("cpu")


def test_params_roundtrip(tmp_path):
    jparams = numpy_params(SMALL, seed=0)
    params = params_from_jax(jparams, CPU)
    assert params[0]["W"].shape == (2, 16) and params[0]["b"].shape == (1, 16)
    back = params_to_numpy(params)
    for a, b in zip(jparams, back):
        for k in ("W", "b"):
            np.testing.assert_array_equal(a[k], b[k])

    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    path = save_params_npz(str(tmp_path / "p.npz"), spec, params, 1.0, 0.01,
                           experiment="unit", extra=np.arange(3))
    loaded = load_params_npz(path)
    assert loaded["spec"] == spec
    assert loaded["experiment"] == "unit"
    assert loaded["lambda2"] == pytest.approx(0.01)
    for a, b in zip(jparams, loaded["params"]):
        for k in ("W", "b"):
            np.testing.assert_array_equal(a[k], b[k])


def test_normalize_inputs_matches_jax():
    x = numpy_points(257, seed=1)
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    jspec = jmlp.MLPSpec(layers=SMALL, lb=LB, ub=UB)
    got = normalize_inputs(spec, torch.from_numpy(x)).numpy()
    want = np.asarray(jmlp.normalize_inputs(jspec, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() >= -1.0 - 1e-6 and got.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("layers", [SMALL, NARROW], ids=["16x3", "20x8"])
def test_mlp_apply_matches_jax(layers):
    jparams = numpy_params(layers, seed=2)
    x = numpy_points(300, seed=3)
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    jspec = jmlp.MLPSpec(layers=layers, lb=LB, ub=UB)
    got = mlp_apply(spec, params_from_jax(jparams, CPU), torch.from_numpy(x)).numpy()
    want = np.asarray(jmlp.mlp_apply(
        jspec, [{k: jnp.asarray(v) for k, v in p.items()} for p in jparams], jnp.asarray(x)
    ))
    assert got.shape == (300, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_mlp_module_is_mlp_apply():
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    params = params_from_jax(numpy_params(SMALL, seed=4), CPU)
    model = MLP(spec, params=params, device=CPU)
    x = torch.from_numpy(numpy_points(50, seed=5))
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(), mlp_apply(spec, params, x).numpy())
    assert sum(p.numel() for p in model.parameters()) == spec.n_params


def test_init_mlp_bounds_and_zero_bias():
    spec = MLPSpec(layers=(2, 64, 64, 1), lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(0), CPU)
    for layer, (din, dout) in zip(params, zip(spec.layers[:-1], spec.layers[1:])):
        std = math.sqrt(2.0 / (din + dout))
        w = layer["W"]
        assert w.shape == (din, dout) and w.dtype == torch.float32
        assert float(w.abs().max()) <= 2.0 * std + 1e-6
        assert torch.count_nonzero(layer["b"]) == 0 and layer["b"].shape == (1, dout)
    # the 64x64 layer's spread is that of a +/-2 sigma truncated normal (0.880 sigma)
    w = params[1]["W"]
    assert float(w.std()) == pytest.approx(0.880 * math.sqrt(2.0 / 128), rel=0.05)


def test_init_mlp_deterministic_per_seed():
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    a = init_mlp(spec, torch.Generator().manual_seed(7), CPU)
    b = init_mlp(spec, torch.Generator().manual_seed(7), CPU)
    c = init_mlp(spec, torch.Generator().manual_seed(8), CPU)
    assert all(torch.equal(p["W"], q["W"]) for p, q in zip(a, b))
    assert not torch.equal(a[0]["W"], c[0]["W"])


@pytest.mark.parametrize(
    "extra", [{"fourier": ((1.0, 2.0),)}, {"n_paths": 2}], ids=["fourier", "paths"]
)
def test_unported_embeddings_raise(extra):
    with pytest.raises(NotImplementedError, match="slice 2"):
        MLPSpec(layers=SMALL, lb=LB, ub=UB, **extra)


def test_spec_bounds_validated():
    with pytest.raises(ValueError, match="lb/ub"):
        MLPSpec(layers=SMALL, lb=(0.0,), ub=(1.0, 1.0))
