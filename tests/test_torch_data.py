"""Port parity: datasets (the committed TwoSin grid, the training sets) and
the samplers, including the Philox stream the fused CUDA step reproduces."""

import os

import numpy as np
import pytest
import torch

from pinns_tpu.data import datasets as jds
from pinns_tpu_torch.data import datasets as tds
from pinns_tpu_torch.data.sampling import (
    latin_hypercube,
    philox4x32_10,
    philox_uniform,
    scale_to_bounds,
    uniform_box,
)

GRID = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                    "twosin_burgers_shock.npz")


@pytest.fixture(scope="module")
def grids():
    """The committed grid through the port's loader, and the same arrays as a
    JAX GridDataset."""
    port = tds.load_burgers_mat("twosin_burgers_shock")
    with np.load(GRID) as z:
        jax_ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                                 provenance=str(z["provenance"]))
    return port, jax_ds


def test_committed_grid_loads(grids):
    port, jax_ds = grids
    assert port.fields["u"].shape == (101, 513) and port.n_points == 51_813
    assert port.provenance == "native" and port.name == "twosin_burgers_shock"
    np.testing.assert_array_equal(port.X_star, jax_ds.X_star)
    np.testing.assert_array_equal(port.star["u"], jax_ds.star["u"])
    np.testing.assert_array_equal(port.lb, jax_ds.lb)
    np.testing.assert_array_equal(port.ub, jax_ds.ub)
    assert tuple(port.lb) == (-1.0, 0.0) and tuple(port.ub) == (1.0, 1.0)


@pytest.mark.parametrize("build", ["build_ic_bc_training_set", "interior_training_set"])
def test_training_sets_match_jax(grids, build):
    port, jax_ds = grids
    tx, tt = getattr(tds, build)(port, 100, seed=1234, noise=0.01)
    jx, jt = getattr(jds, build)(jax_ds, 100, seed=1234, noise=0.01)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tt["u"], jt["u"])
    np.testing.assert_array_equal(tds.ic_bc_candidates(port), jds.ic_bc_candidates(jax_ds))


def test_loader_paths_and_errors(tmp_path, monkeypatch):
    monkeypatch.delenv("PINNS_TPU_DATA_ROOT", raising=False)
    assert tds.resolve_grid_path("twosin_burgers_shock") == GRID
    assert tds.load_burgers_mat(GRID).name == "twosin_burgers_shock"
    assert tds.load_burgers_mat("abgrall_burgers_shock").provenance == "native"
    with monkeypatch.context() as m:  # a key with no committed grid is generated natively
        m.setattr(tds, "GRID_DIR", tmp_path)
        assert tds.resolve_grid_path("burgers_shock") is None
        native = tds.load_burgers_mat("burgers_shock", device="cpu")
        assert native.provenance == "native" and native.fields["u"].shape == (100, 256)
    with pytest.raises(FileNotFoundError, match="neither a known key"):
        tds.load_burgers_mat(str(tmp_path / "missing.npz"))
    euler = tds.load_euler_mat()  # the key builds the exact grid natively
    assert euler.provenance == "native" and euler.field_names == ("rho", "u", "E")


def test_philox_known_answers():
    """Random123's Philox-4x32-10 known-answer vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10([torch.tensor([c]) for c in ctr], key)
        assert tuple(int(w) for w in got) == want


def test_philox_uniform_stream():
    lb, ub = (-1.0, 0.0), (1.0, 0.99)
    a = philox_uniform(1234, 7, 4096, lb, ub)
    assert a.shape == (4096, 2) and a.dtype == torch.float32
    assert torch.equal(a, philox_uniform(1234, 7, 4096, lb, ub))  # counter-based
    assert torch.equal(a[:100], philox_uniform(1234, 7, 100, lb, ub))  # prefix-stable
    assert not torch.equal(a, philox_uniform(1234, 8, 4096, lb, ub))
    assert not torch.equal(a, philox_uniform(1235, 7, 4096, lb, ub))
    lo, hi = torch.tensor(lb), torch.tensor(ub)
    assert bool(((a >= lo) & (a < hi)).all())
    # mean and variance of U[lb, ub) within 4 sigma of the sample statistics
    mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
    n = a.shape[0]
    assert bool(((a.mean(0) - mean).abs() <= 4 * (var / n).sqrt()).all())
    assert bool(((a.var(0) - var).abs() <= 4 * var * (0.8 / n) ** 0.5).all())


def test_generator_samplers():
    g = torch.Generator().manual_seed(3)
    pts = uniform_box(g, 500, (-1.0, 0.0), (1.0, 2.0))
    assert pts.shape == (500, 2)
    assert bool((pts[:, 0] >= -1).all() and (pts[:, 0] <= 1).all())
    assert bool((pts[:, 1] >= 0).all() and (pts[:, 1] <= 2).all())
    unit = latin_hypercube(torch.Generator().manual_seed(4), 50, 2)
    for d in range(2):  # one point per stratum in each dimension
        strata = torch.sort((unit[:, d] * 50).floor()).values
        assert torch.equal(strata, torch.arange(50, dtype=torch.float32))
    box = scale_to_bounds(unit, (-1.0, 0.0), (1.0, 2.0))
    assert torch.allclose(box, unit * torch.tensor([2.0, 2.0]) + torch.tensor([-1.0, 0.0]))
