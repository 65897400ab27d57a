"""The port's nested-jvp derivatives (``pinns_tpu_torch.ops.derivatives``)
against the JAX package's ``derivs_*_jvp`` and against the port's own
Taylor-mode streams, on the same numpy-seeded params and points (CPU,
float32). Tolerance per stream: rtol 1e-5, atol 1e-5 max|reference|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.models.mlp import mlp_apply as jax_apply
from pinns_tpu.ops.derivatives import derivs_1_jvp as jax_d1
from pinns_tpu.ops.derivatives import derivs_2_jvp as jax_d2
from pinns_tpu_torch.interop import params_from_jax
from pinns_tpu_torch.models.mlp import MLPSpec, mlp_apply
from pinns_tpu_torch.ops.derivatives import derivs_1_jvp, derivs_2_jvp
from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference, mlp_taylor_2_reference
from torch_port_util import numpy_params

RTOL, ATOL_REL = 1e-5, 1e-5
CPU = torch.device("cpu")
NETS = {
    "euler_like": ((2, 16, 16, 16, 3), (0.0, 0.0), (1.0, 0.2)),
    "burgers": ((2, 20, 20, 20, 1), (-1.0, 0.0), (1.0, 1.0)),
}


def close(got, want, name):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()), err_msg=name)


def inputs(net: str, seed: int = 0, n: int = 64):
    layers, lb, ub = NETS[net]
    params = numpy_params(layers, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(lb, ub, size=(n, 2)).astype(np.float32)
    jspec = JSpec(layers=layers, lb=lb, ub=ub)
    tspec = MLPSpec(layers=layers, lb=lb, ub=ub)
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return jspec, jparams, tspec, params_from_jax(params, CPU), x


@pytest.mark.parametrize("net", sorted(NETS))
def test_derivs_1_jvp_matches_jax_and_taylor1(net):
    jspec, jparams, tspec, tparams, x = inputs(net)
    got = derivs_1_jvp(lambda z: mlp_apply(tspec, tparams, z), torch.from_numpy(x))
    want = jax_d1(lambda z: jax_apply(jspec, jparams, z), jnp.asarray(x))
    taylor = mlp_taylor_1_reference(tspec, tparams, torch.from_numpy(x))
    for name, g, w, t in zip(("y", "y_x", "y_t"), got, want, taylor):
        assert g.shape == (x.shape[0], NETS[net][0][-1])
        close(g.detach().numpy(), np.asarray(w), f"{name} vs JAX")
        close(g.detach().numpy(), t.detach().numpy(), f"{name} vs Taylor-1")


@pytest.mark.parametrize("net", sorted(NETS))
def test_derivs_2_jvp_matches_jax_and_taylor2(net):
    jspec, jparams, tspec, tparams, x = inputs(net, seed=2)
    got = derivs_2_jvp(lambda z: mlp_apply(tspec, tparams, z), torch.from_numpy(x))
    want = jax_d2(lambda z: jax_apply(jspec, jparams, z), jnp.asarray(x))
    taylor = mlp_taylor_2_reference(tspec, tparams, torch.from_numpy(x))
    for name, g, w, t in zip(("y", "y_x", "y_t", "y_xx"), got, want, taylor):
        close(g.detach().numpy(), np.asarray(w), f"{name} vs JAX")
        close(g.detach().numpy(), t.detach().numpy(), f"{name} vs Taylor-2")


def test_derivs_of_a_custom_apply_function():
    """Any apply function: u = sin(x) exp(-t) has u_x = cos(x) exp(-t),
    u_t = -u, u_xx = -u (float64, to rounding)."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (32, 2)))
    fn = lambda z: (torch.sin(z[:, :1]) * torch.exp(-z[:, 1:]))  # noqa: E731
    y, y_x, y_t, y_xx = derivs_2_jvp(fn, x)
    u = torch.sin(x[:, :1]) * torch.exp(-x[:, 1:])
    torch.testing.assert_close(y, u)
    torch.testing.assert_close(y_x, torch.cos(x[:, :1]) * torch.exp(-x[:, 1:]))
    torch.testing.assert_close(y_t, -u)
    torch.testing.assert_close(y_xx, -u)
    y1, y1_x, y1_t = derivs_1_jvp(fn, x)
    assert torch.equal(y1, y) and torch.equal(y1_x, y_x) and torch.equal(y1_t, y_t)
