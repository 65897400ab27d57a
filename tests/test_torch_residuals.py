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
    """predict_fields takes a Problem and the params tree, as in JAX; the
    served model's burgers_fields is the same pass on a bare network."""
    import dataclasses

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.evaluate import burgers_fields
    from pinns_tpu_torch.train.trainer import Problem

    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB)
    net = params_from_jax(numpy_params(SMALL, 24), CPU)
    x = torch.from_numpy(numpy_points(9, seed=25))
    exp = override(get_preset("burgers_forward"), {"model.layers": SMALL})
    problem = Problem(exp=exp, dataset=None, spec=spec, x_data=None, targets={})
    params = {"net": net, "coeffs": {"lambda1": torch.ones(1), "lambda2": torch.full((1,), NU)}}
    out = predict_fields(problem, params, x)
    u, f = burgers_residual(spec, net, x, params["coeffs"]["lambda1"], params["coeffs"]["lambda2"])
    assert sorted(out) == ["f", "u"]
    assert torch.equal(out["u"], u) and torch.equal(out["f"], f)
    bare = burgers_fields(spec, net, x, params["coeffs"]["lambda1"], params["coeffs"]["lambda2"])
    assert torch.equal(bare["u"], u) and torch.equal(bare["f"], f)
    # the Euler branch: the six outputs of the Euler residuals of a 3-output net
    from pinns_tpu_torch.ops.residuals import euler_residuals

    layers3 = SMALL[:-1] + (3,)
    spec3 = MLPSpec(layers=layers3, lb=LB, ub=UB)
    net3 = params_from_jax(numpy_params(layers3, 26), CPU)
    euler = dataclasses.replace(problem, exp=override(exp, {"pde.kind": "euler"}), spec=spec3)
    out = predict_fields(euler, dict(params, net=net3), x)
    fields, res = euler_residuals(spec3, net3, x, 1.4)
    assert sorted(out) == ["E", "f1", "f2", "f3", "rho", "u"]
    for name, want in zip(("rho", "u", "E", "f1", "f2", "f3"), fields + res):
        assert torch.equal(out[name], want)


def test_relative_l2():
    exact = np.array([3.0, 4.0])
    assert relative_l2(exact, exact) == 0.0
    assert relative_l2(np.zeros(2), exact) == pytest.approx(1.0)
    assert relative_l2(np.array([3.0, 3.0]), exact) == pytest.approx(0.2)
