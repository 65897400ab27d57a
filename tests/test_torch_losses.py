"""Port parity: prox, misfit, ADMM and Adam against the JAX package / optax.

Inputs come from numpy with a seed; tolerances are float32 rounding
(rtol 1e-6 on elementwise results, 1e-5 on sums over 64 points).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinns_tpu.losses import admm as jadmm
from pinns_tpu.losses import misfit as jmisfit
from pinns_tpu.ops.prox import soft_threshold as jsoft
from pinns_tpu_torch.losses import admm as tadmm
from pinns_tpu_torch.losses import misfit as tmisfit
from pinns_tpu_torch.ops.prox import soft_threshold
from pinns_tpu_torch.opt.adam import adam_init, adam_update, apply_updates, tree_map

RHO = 10.0


def _vec(seed, n=64, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, 1))).astype(np.float32)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_soft_threshold_matches_jax():
    v = _vec(1)
    v[:4] = [[0.0], [0.05], [-0.05], [0.1]]  # at, inside and on the threshold
    _close(soft_threshold(torch.from_numpy(v), 0.1), jsoft(jnp.asarray(v), 0.1))


@pytest.mark.parametrize("kind", jmisfit.DATA_MISFIT_KINDS)
def test_data_misfit_matches_jax(kind):
    pred, target = _vec(2, 16), _vec(3, 16)
    got = tmisfit.data_misfit(torch.from_numpy(pred), torch.from_numpy(target), kind, 16)
    _close(float(got), jmisfit.data_misfit(jnp.asarray(pred), jnp.asarray(target), kind, 16),
           rtol=1e-5)


@pytest.mark.parametrize("kind", jmisfit.RESIDUAL_PENALTY_KINDS)
def test_residual_penalty_matches_jax(kind):
    f = _vec(4)
    got = tmisfit.residual_penalty(torch.from_numpy(f), kind, 64)
    _close(float(got), jmisfit.residual_penalty(jnp.asarray(f), kind, 64), rtol=1e-5)


def test_unknown_kinds_raise():
    t = torch.zeros(3, 1)
    with pytest.raises(ValueError, match="unknown"):
        tmisfit.data_misfit(t, t, "l3", 3)
    with pytest.raises(ValueError, match="unknown"):
        tmisfit.residual_penalty(t, "l3", 3)


@pytest.mark.parametrize("explicit_inner", [False, True])
def test_admm_matches_jax(explicit_inner):
    f0, f, dual = _vec(5, scale=0.3), _vec(6, scale=0.3), 1.0 + _vec(7, scale=0.1)
    js = jadmm.admm_init(jnp.asarray(f0))
    ts = tadmm.admm_init(torch.from_numpy(f0))
    _close(ts.z, js.z)
    _close(ts.dual, js.dual)
    js = jadmm.ADMMState(z=js.z, dual=jnp.asarray(dual))
    ts = tadmm.ADMMState(z=ts.z, dual=torch.from_numpy(dual))
    _close(float(tadmm.admm_penalty(torch.from_numpy(f), ts, RHO, explicit_inner)),
           jadmm.admm_penalty(jnp.asarray(f), js, RHO, explicit_inner), rtol=1e-5)
    jn = jadmm.admm_update(jnp.asarray(f), js, RHO, 64)
    tn = tadmm.admm_update(torch.from_numpy(f), ts, RHO, 64)
    _close(tn.z, jn.z, atol=1e-7)
    _close(tn.dual, jn.dual, atol=1e-6)
    _close(float(tadmm.admm_misfit(torch.from_numpy(f), tn)), jadmm.admm_misfit(jnp.asarray(f), jn),
           rtol=1e-5)


def test_admm_rejects_systems_until_slice_2():
    """Slice 2a brought the systems: a tuple of residuals gets a tuple state,
    one component each (the values against JAX: tests/test_torch_euler.py)."""
    st = tadmm.admm_init((torch.zeros(3, 1), torch.ones(3, 1)))
    assert isinstance(st.z, tuple) and len(st.z) == 2
    assert torch.equal(st.z[1], torch.ones(3, 1)) and torch.equal(st.dual[0], torch.ones(3, 1))


def test_adam_matches_optax_over_steps():
    """Three Adam steps on given gradients (including exact zeros, as frozen
    coefficients get): params, count, mu and nu equal optax's."""
    rng = np.random.default_rng(8)
    draw = lambda scale: {  # noqa: E731
        "net": [{"W": (scale * rng.standard_normal((3, 4))).astype(np.float32),
                 "b": (scale * rng.standard_normal((1, 4))).astype(np.float32)}],
        "coeffs": {"lambda1": (scale * rng.standard_normal(1)).astype(np.float32)},
    }
    params = draw(1.0)
    opt = optax.adam(1e-3)
    jp = tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = tree_map(torch.from_numpy, params)
    tstate = adam_init(tp)
    for k in range(3):
        g = draw(10.0 ** -k)
        g["coeffs"]["lambda1"][:] = 0.0
        ju, jstate = opt.update(tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = adam_update(tree_map(torch.from_numpy, g), tstate, 1e-3)
        tp = apply_updates(tp, tu)
    adam = jstate[0]
    assert tstate.count == int(adam.count) == 3
    for got, want in ((tp, jp), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        tree_map(lambda a, b: _close(a, b, rtol=1e-6, atol=1e-9), got, want)
    assert float(tp["coeffs"]["lambda1"][0]) == params["coeffs"]["lambda1"][0]
