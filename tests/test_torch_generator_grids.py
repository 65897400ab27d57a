"""The port's full-size TwoSin and Abgrall Burgers grids against the JAX
package's, and the loader's native generation of every dataset key, on the
CPU (the plain version of K12).

Tolerance (the float64 criterion of tests/test_torch_generators.py): the FV
solve's ``steps_per_snap`` and pre-steps equal JAX's, and max|port - JAX|
over the grid within F64_FACTOR times the larger of the two float32 errors
against the port's float64 run of the same grid; the numpy grids
(``burgers_shock``, ``abgrall_eulers``) within 1e-12 of max|JAX|.
"""

import numpy as np
import pytest
import torch

from pinns_tpu.data import datasets as jds
from pinns_tpu.data import generators as jgen
from pinns_tpu_torch.data import datasets as tds
from pinns_tpu_torch.data import generators as tgen
from test_torch_generators import F64_FACTOR, ORACLE_RTOL, jax_burgers_steps

GRIDS = {  # key -> (the grid maker, its solve's arguments, its IC)
    "twosin_burgers_shock": ("make_twosin_grid", "twosin_fv_args", "two_sin_ic"),
    "abgrall_burgers_shock": ("make_abgrall_burgers_grid", "abgrall_fv_args",
                              "abgrall_burgers_ic"),
}


@pytest.fixture(scope="module")
def grids():
    """key -> (JAX's grid, the port's float32 grid, the port's float64 grid)."""
    out = {}
    for key, (maker, _, _) in GRIDS.items():
        out[key] = (getattr(jgen, maker)(), getattr(tgen, maker)(device="cpu"),
                    getattr(tgen, maker)(device="cpu", dtype=torch.float64))
    return out


def criterion(port, jax, port64):
    port, jax, port64 = (np.asarray(a, np.float64) for a in (port, jax, port64))
    diff = float(np.abs(port - jax).max())
    err = max(float(np.abs(port - port64).max()), float(np.abs(jax - port64).max()))
    return diff, err


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_full_size_grid_matches_jax(grids, key):
    _, fv_args, ic = GRIDS[key]
    kw = getattr(tgen, fv_args)()
    assert kw.pop("ic") is getattr(tgen, ic)
    plan = tgen.burgers_plan(getattr(tgen, ic), device="cpu", **kw)
    assert (plan.steps_per_snap, plan.offset_steps) == jax_burgers_steps(getattr(jgen, ic), **kw)
    jax, port, port64 = grids[key]
    assert sorted(port) == sorted(jax) == ["t", "usol", "x"]
    np.testing.assert_array_equal(port["x"], jax["x"])
    np.testing.assert_array_equal(port["t"], jax["t"])
    assert port["usol"].shape == jax["usol"].shape
    diff, err = criterion(port["usol"], jax["usol"], port64["usol"])
    assert diff <= F64_FACTOR * err, f"{key}: |port - JAX| {diff} vs float32 error {err}"


@pytest.mark.parametrize("key", ["abgrall_burgers_shock", "abgrall_eulers", "burgers_shock",
                                 "twosin_burgers_shock"])
def test_loader_generates_every_key_natively(grids, key, tmp_path, monkeypatch):
    """With no reference tree and no committed grid, each key is generated,
    provenance 'native', on the CPU when asked, and meets JAX's
    ``_generate_fallback`` grid."""
    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    monkeypatch.setattr(tds, "GRID_DIR", tmp_path)
    jax = jds._generate_fallback(key)
    if key == "abgrall_eulers":
        ds = tds.load_euler_mat(key)
        pairs = {"rho": "rhosol", "u": "usol", "E": "Enersol"}
    else:
        assert tds.resolve_grid_path(key) is None
        ds = tds.load_burgers_mat(key, device="cpu")
        pairs = {"u": "usol"}
    assert ds.provenance == "native" and ds.name == key
    np.testing.assert_array_equal(ds.x, np.asarray(jax["x"], np.float32).reshape(-1, 1))
    np.testing.assert_array_equal(ds.t, np.asarray(jax["t"], np.float32).reshape(-1, 1))
    for field, mat_key in pairs.items():
        got, want = ds.fields[field].T, np.asarray(jax[mat_key])
        assert got.shape == want.shape
        if key in GRIDS:  # the float32 FV grid, then float32 storage
            _, _, port64 = grids[key]
            diff, err = criterion(got, want, port64["usol"])
            assert diff <= F64_FACTOR * err, f"{key}: |port - JAX| {diff} vs {err}"
        else:  # numpy float64, stored in float32
            np.testing.assert_allclose(got, want.astype(np.float32), rtol=0,
                                       atol=ORACLE_RTOL * float(np.abs(want).max()))
