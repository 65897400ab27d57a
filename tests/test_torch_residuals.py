"""Port parity: pinns_tpu_torch.ops.residuals + train.evaluate against pinns_tpu."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.residuals import burgers_residual_aux as jax_burgers_aux
from pinns_tpu_torch.interop import load_params_npz, params_from_jax
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.residuals import burgers_residual, burgers_residual_aux
from pinns_tpu_torch.train.evaluate import predict_fields, relative_l2
from torch_port_util import FIXTURE, LB, SMALL, UB, assert_close, numpy_params, numpy_points

CPU = torch.device("cpu")
NU = 0.01 / math.pi


def _jax(spec, jparams, x, lam1, lam2):
    jspec = JSpec(layers=spec.layers, lb=spec.lb, ub=spec.ub)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in jparams]
    lam = lambda v: jnp.full((1,), v, jnp.float32)  # noqa: E731  (as Problem holds them)
    return [np.asarray(a) for a in jax_burgers_aux(jspec, jp, jnp.asarray(x), lam(lam1), lam(lam2))]


@pytest.mark.parametrize("which", ["16x3", "20x8-trained"])
def test_burgers_residual_matches_jax(which):
    if which == "16x3":
        spec, jparams, lam1, lam2 = MLPSpec(layers=SMALL, lb=LB, ub=UB), numpy_params(SMALL, 20), 0.8, 0.05
    else:
        loaded = load_params_npz(FIXTURE)
        spec, jparams = loaded["spec"], loaded["params"]
        lam1, lam2 = loaded["lambda1"], loaded["lambda2"]
    x = numpy_points(401, seed=21)
    got = burgers_residual_aux(spec, params_from_jax(jparams, CPU), torch.from_numpy(x), lam1, lam2)
    want = _jax(spec, jparams, x, lam1, lam2)
    for name, g, w in zip(("u", "f", "u_x", "u_t"), got, want):
        assert g.shape == (401, 1)
        assert_close(name, g.numpy(), w)


def test_burgers_residual_is_aux_prefix():
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    params = params_from_jax(numpy_params(SMALL, 22), CPU)
    x = torch.from_numpy(numpy_points(17, seed=23))
    u, f = burgers_residual(spec, params, x, 1.0, NU)
    ua, fa, _, _ = burgers_residual_aux(spec, params, x, 1.0, NU)
    assert torch.equal(u, ua) and torch.equal(f, fa)


def test_predict_fields_burgers_and_euler():
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    params = params_from_jax(numpy_params(SMALL, 24), CPU)
    x = torch.from_numpy(numpy_points(9, seed=25))
    out = predict_fields(spec, params, x, 1.0, NU)
    u, f = burgers_residual(spec, params, x, 1.0, NU)
    assert sorted(out) == ["f", "u"]
    assert torch.equal(out["u"], u) and torch.equal(out["f"], f)
    with pytest.raises(NotImplementedError, match="slice 2"):
        predict_fields(spec, params, x, 1.0, NU, pde="euler")


def test_relative_l2():
    exact = np.array([3.0, 4.0])
    assert relative_l2(exact, exact) == 0.0
    assert relative_l2(np.zeros(2), exact) == pytest.approx(1.0)
    assert relative_l2(np.array([3.0, 3.0]), exact) == pytest.approx(0.2)
