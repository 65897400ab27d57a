"""Port parity for sweeps (``pinns_tpu_torch.parallel.sweep``): the grid and
its grouping against the JAX package's, value-only axes (seed, rho) as one
ensemble unit whose members equal their solo runs, failures recorded (and
``sweep`` exiting 1), the JSONL sink, and concurrent units over several
devices (slice 6). Tiny abgrall_admm runs on the CPU (net
2 -> 8x2 -> 1, N_f 64, N_u 16) on the committed TwoSin grid.
"""

import json
import os

import pytest

from pinns_tpu.parallel import sweep as jsweep
from pinns_tpu_torch import cli
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.parallel import sweep as tsweep
from pinns_tpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
TINY = {"model.layers": (2, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 16,
        "optimizer.kind": "adam", "train.epochs": 4, "train.chunk": 2, "train.log_every": 0}

GRIDS = [
    {"loss.rho": [10.0, 40.0], "train.seed": [1234, 7]},
    {"sampling.n_f": [100, 200], "loss.rho": [10], "model.layers": [(2, 8, 1), (2, 16, 1)]},
    {"train.seed": [1, 2, 3]},
    {},
]


@pytest.mark.parametrize("lists", GRIDS, ids=["rho_seed", "shapes", "seeds", "empty"])
def test_grid_and_grouping_match_jax(lists):
    grid = tsweep.cartesian_grid(lists)
    assert grid == jsweep.cartesian_grid(lists)
    assert [tsweep._group_key(ov) for ov in grid] == [jsweep._group_key(ov) for ov in grid]
    assert tsweep._VMAPPABLE == jsweep._VMAPPABLE


def _base(**extra):
    return override(get_preset("abgrall_admm"), dict(TINY, **extra))


def test_rho_seed_axes_run_as_one_ensemble_unit(monkeypatch, tmp_path):
    """loss.rho x train.seed is one unit: run_ensemble once, every row ok in
    grid order with its own summary, each member equal to its solo run; the
    JSONL sink holds one row a configuration."""
    calls = []
    real = tens.run_ensemble

    def counted(trainer, seeds, rhos=None, **kw):
        calls.append((list(seeds), rhos))
        return real(trainer, seeds, rhos=rhos, **kw)

    monkeypatch.setattr(tens, "run_ensemble", counted)
    grid = tsweep.cartesian_grid({"loss.rho": [10.0, 40.0], "train.seed": [1234, 7]})
    out = tmp_path / "sweep.jsonl"
    results = tsweep.run_sweep(_base(), grid, out_path=str(out), device="cpu", dataset=GRID)
    assert calls == [([1234, 7, 1234, 7], [10.0, 10.0, 40.0, 40.0])]
    assert [r.overrides for r in results] == grid
    assert all(r.status == "ok" and r.device == "cpu" for r in results)
    assert len({(r.t_start, r.t_end) for r in results}) == 1  # one unit
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert sorted(json.dumps(r["overrides"], sort_keys=True) for r in rows) == \
        sorted(json.dumps(ov, sort_keys=True) for ov in grid)
    for r in results:
        solo_tr = ttrainer.Trainer(override(_base(), r.overrides), device="cpu", dataset=GRID)
        _, summary = solo_tr.train()
        assert r.summary["rel_l2_u"] == summary["rel_l2_u"]
        assert r.summary["epochs"] == summary["epochs"] == TINY["train.epochs"]


def test_failed_configuration_is_recorded_and_sweep_exits_1(capsys):
    """A configuration that cannot train is recorded as failed after its
    retries, the others run, and the CLI exits 1."""
    grid = [{"loss.residual_kind": "admm"}, {"loss.residual_kind": "bogus"},
            {"no_such.key": 1}]
    results = tsweep.run_sweep(_base(), grid, retries=1, device="cpu", dataset=GRID)
    assert [r.status for r in results] == ["ok", "failed", "failed"]
    assert results[1].attempts == 2 and "bogus" in results[1].error
    assert results[0].summary is not None and results[1].summary is None
    argv = ["sweep", "--preset", "abgrall_admm", "--device", "cpu", "--data", GRID,
            "--epochs", "2", "--retries", "0", "--set", "model.layers=(2,8,8,1)",
            "--set", "sampling.n_f=64", "--set", "data.n_u=16", "--set", "optimizer.kind=adam"]
    assert cli.main(argv + ["--grid", "loss.residual_kind=admm,bogus"]) == 1
    out = capsys.readouterr().out
    assert "1/2 configurations succeeded" in out
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["status"] for r in rows] == ["ok", "failed"] and "error" in rows[1]
    assert cli.main(argv + ["--grid", "train.seed=3,4"]) == 0


def test_units_run_in_turn_on_one_card(capsys):
    """Groups that cannot batch run as serial units (a log line says so);
    several units over several devices run concurrently, one worker process
    a device (slice 6: two CPU worker names here), results in grid order."""
    grid = tsweep.cartesian_grid({"sampling.n_f": [32, 64, 32, 64]})
    results = tsweep.run_sweep(_base(), [dict(g, **{"train.epochs": 10 + i})
                                         for i, g in enumerate(grid)],
                               devices=["cpu:0", "cpu:1"], device="cpu", dataset=GRID)
    assert [r.status for r in results] == ["ok"] * 4
    assert [r.overrides["train.epochs"] for r in results] == [10, 11, 12, 13]
    assert [r.summary["epochs"] for r in results] == [10, 11, 12, 13]
    assert {r.device for r in results} == {"cpu:0", "cpu:1"}
    assert "concurrently over 2 devices" in capsys.readouterr().out
    grid = tsweep.cartesian_grid({"sampling.n_f": [32, 64]})
    results = tsweep.run_sweep(_base(), grid, devices=["cuda:0", "cuda:1"], concurrent=False,
                               device="cpu", dataset=GRID)
    assert [r.status for r in results] == ["ok", "ok"]
    assert results[0].t_end <= results[1].t_start
    mixed = [{"train.seed": 1}, {"sampling.n_f": 32}]
    results = tsweep.run_sweep(_base(), mixed, group_seeds=False, device="cpu", dataset=GRID)
    assert [r.status for r in results] == ["ok", "ok"]
    same = [{"train.seed": 1}, {"train.seed": 2}]
    tsweep.run_sweep(_base(), same, group_seeds=False, device="cpu", dataset=GRID)
    assert "serial units" in capsys.readouterr().out


def test_sweep_members_keep_their_rho():
    """An ensemble unit over rho alone: each member trains at its rho (its
    state carries it) with the base seed."""
    grid = tsweep.cartesian_grid({"loss.rho": [1.0, 40.0]})
    results = tsweep.run_sweep(_base(), grid, device="cpu", dataset=GRID)
    assert all(r.status == "ok" for r in results)
    losses = []
    for ov in grid:
        tr = ttrainer.Trainer(override(_base(), ov), device="cpu", dataset=GRID)
        state, summary = tr.train()
        losses.append(summary["rel_l2_u"])
        assert state.rho is None
    assert [r.summary["rel_l2_u"] for r in results] == losses
    assert losses[0] != losses[1]


def test_concurrent_units_stress(tmp_path):
    """More units than worker processes, each worker taking several from the
    one queue: every configuration gets exactly one result, in grid order,
    with its own epochs, and the JSONL sink exactly one row each (the parent
    alone writes them, as the workers' results arrive)."""
    n, workers = 12, 4
    grid = [{"sampling.n_f": 32 + 4 * (i % 3), "train.epochs": 2 + i} for i in range(n)]
    out = str(tmp_path / "stress.jsonl")
    results = tsweep.run_sweep(_base(), grid, out_path=out,
                               devices=[f"cpu:{k}" for k in range(workers)], device="cpu",
                               dataset=GRID)
    assert [r.status for r in results] == ["ok"] * n
    assert [r.summary["epochs"] for r in results] == [2 + i for i in range(n)]
    assert {r.device for r in results} <= {f"cpu:{k}" for k in range(workers)}
    with open(out) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert sorted(r["overrides"]["train.epochs"] for r in rows) == [2 + i for i in range(n)]


def _exiting_worker(dev, job, tasks, results):
    """A worker process that dies in the first unit it takes (module level:
    the spawned process imports it)."""
    i, _ = tasks.get()
    results.put(("start", i, dev))
    results.close()
    results.join_thread()
    os._exit(3)


def test_dead_worker_records_its_unit(monkeypatch):
    """A unit whose worker process dies records that as its failure, naming
    the device and the exit code; a unit that no worker took says so."""
    monkeypatch.setattr(tsweep, "_device_worker", _exiting_worker)
    grid = [{"sampling.n_f": 32 + 4 * i} for i in range(3)]
    results = tsweep.run_sweep(_base(), grid, devices=["cpu:a", "cpu:b"], device="cpu",
                               dataset=GRID)
    assert [r.status for r in results] == ["failed"] * 3
    assert {r.device for r in results[:2]} == {"cpu:a", "cpu:b"}
    for r in results[:2]:
        assert r.error == f"the worker process on {r.device} exited with code 3"
    assert results[2].device is None and results[2].error == "no worker process took this unit"
