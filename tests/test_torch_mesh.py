"""Port parity for the process mesh (``pinns_tpu_torch.parallel.mesh``) and
for ensembles spread over it (slice 6): ``make_mesh`` against JAX's
``make_mesh`` on the 8 virtual CPU devices of ``tests/conftest.py`` (the same
shapes, grids and ``ValueError``s), the launch without torchrun and its
refusal of a missing card, and members over 2 and 4 gloo ranks
(``tests/torch_dp_worker.py``): each member bit-equal to its solo run of the
port with no collective in the training, and with a data axis of 2 at
least one all-reduce an epoch. Tiny abgrall_admm runs (net 2 -> 8x2 -> 1,
N_f 64, N_u 16) on the committed TwoSin grid; every spawn has a timeout.
"""

import jax
import numpy as np
import pytest
import torch

from pinns_tpu.parallel.mesh import make_mesh as jmake_mesh
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.parallel import mesh as tmesh
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import trainer as ttrainer
from torch_dp_worker import GRID, spawn

UPDATES = {"model.layers": (2, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 16,
           "optimizer.kind": "adam", "train.log_every": 0, "train.epochs": 20,
           "train.chunk": 10}
MESHES = [(0, 1), (8, 1), (4, 2), (2, 4), (1, 8), (0, 2), (0, 4), (3, 2), (1, 1)]
BAD = [(16, 1), (0, 3), (3, 3), (9, 1), (0, 5)]


@pytest.mark.parametrize("data,ensemble", MESHES)
def test_make_mesh_matches_jax(data, ensemble):
    """The same (ensemble, data) shape and the same grid of ranks as JAX's
    devices (device i is rank i)."""
    assert len(jax.devices()) == 8
    want = jmake_mesh(data=data, ensemble=ensemble)
    got = tmesh.make_mesh(data=data, ensemble=ensemble, ranks=range(8))
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(np.asarray(got.grid), ids)
    # a layout only (no process group): rank 0's coordinates, no groups
    assert got.coords == (0, 0) and got.data_group is None and got.ensemble_group is None


@pytest.mark.parametrize("data,ensemble", BAD)
def test_make_mesh_refusals_match_jax(data, ensemble):
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(data=data, ensemble=ensemble)
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(data=data, ensemble=ensemble, ranks=range(8))
    assert str(terr.value) == str(jerr.value)


def test_multihost_init_without_launcher(monkeypatch):
    """A world of one needs no launcher: no group is joined, the device is
    the caller's; a mesh larger than that world raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.multihost_init("cpu") == (0, 1, "cpu")
    assert tmesh.world() == (0, 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(data=2)


def test_multihost_init_refuses_a_missing_card(monkeypatch):
    """A rank that finds no card for its LOCAL_RANK raises before it joins."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
        tmesh.multihost_init("cuda")


def _solo(seed: int):
    """(final params, summary) of the port's solo run of ``seed``."""
    exp = override(get_preset("abgrall_admm"), UPDATES)
    tr = ttrainer.Trainer(exp, device="cpu", dataset=GRID)
    state, summary = tr.train(tr.init_state(seed=seed))
    return _flat(state.params), summary


def _flat(params) -> np.ndarray:
    return np.concatenate([t.detach().numpy().ravel() for layer in params["net"]
                           for t in layer.values()])


@pytest.mark.parametrize("world", [2, 4])
def test_member_sharded_ensemble_equals_solo_runs(tmp_path, world):
    """run_ensemble over a mesh of `world` ensemble coordinates (data axis
    1): each rank trains its block of the 4 members, writes their
    checkpoints and issues no collective in the training (the summaries'
    one object gather only); every member's final params equal its solo run
    of the port bit for bit; rank 0 holds every member's summary in order."""
    out = str(tmp_path / "ens")
    args = {"out": out, "members": 4, "data": 1,
            "updates": dict(UPDATES, **{"train.out_dir": str(tmp_path)})}
    results = spawn("ensemble", args, world)
    for _, info in results:
        assert info["counts"] == {"gather_object": 1}, info["counts"]
    summaries = results[0][1]["summaries"]
    assert len(summaries) == 4
    for i in range(4):
        params, summary = _solo(1234 + i)
        state = ckpt_io.load_checkpoint(str(tmp_path / f"abgrall_admm_final_m{i}.ckpt"), "cpu")
        np.testing.assert_array_equal(_flat(state.params), params, err_msg=f"member {i}")
        assert summaries[i]["rel_l2_u"] == summary["rel_l2_u"]


def test_data_parallel_ensemble_all_reduces_every_epoch(tmp_path):
    """The contrast leg: the same ensemble data-parallel over 2 ranks (one
    ensemble coordinate, data axis 2) issues at least one all-reduce an
    epoch of every member (two with ADMM: the gradient and the misfit), and
    rank 0 gets both members' summaries."""
    args = {"out": str(tmp_path / "dp"), "members": 2, "data": 2, "updates": UPDATES}
    results = spawn("ensemble", args, 2)
    counts = results[0][1]["counts"]
    assert counts.get("all_reduce", 0) >= 2 * UPDATES["train.epochs"], counts
    assert results[0][1]["coords"] == [0, 0] and results[1][1]["coords"] == [0, 1]
    summaries = results[0][1]["summaries"]
    assert len(summaries) == 2 and all(np.isfinite(s["rel_l2_u"]) for s in summaries)
