"""Hyperparameter sweeps (port of ``pinns_tpu/parallel/sweep.py``, the JAX
package's replacement for the reference's MPI master-worker farm).

The grid is the cartesian product of dotted-key override lists
(:func:`cartesian_grid`). Configurations that differ only in value axes
(``train.seed``, ``loss.rho``) form one ensemble unit
(``parallel.ensemble.run_ensemble``: on the card one K8 epoch for all its
members, replayed from captured graphs (K9), inside K3's narrow scope); any
other configuration is a
solo unit, retried ``retries`` times on failure. Units run in order on the
one card: running units concurrently over several cards comes with slice 6.
Every result is recorded, failures included, and streamed to a JSONL file
when ``out_path`` is given.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pinns_tpu_torch.config import Experiment, override

_VMAPPABLE = ("train.seed", "loss.rho")  # value-only axes: one ensemble unit sweeps them


def cartesian_grid(param_lists: Dict[str, Sequence]) -> List[Dict[str, Any]]:
    """All combinations of dotted-key override lists, in ``itertools.product``
    order: {'sampling.n_f': [100, 200], 'loss.rho': [10]} ->
    [{'sampling.n_f': 100, 'loss.rho': 10}, {'sampling.n_f': 200, ...}]."""
    keys = list(param_lists.keys())
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(param_lists[k] for k in keys))]


@dataclasses.dataclass
class SweepResult:
    overrides: Dict[str, Any]
    status: str  # 'ok' | 'failed'
    summary: Optional[Dict[str, float]] = None
    error: Optional[str] = None
    seconds: float = 0.0
    attempts: int = 1
    device: Optional[str] = None
    t_start: float = 0.0  # monotonic span of the unit
    t_end: float = 0.0


def _group_key(overrides: Dict) -> tuple:
    return tuple(sorted((k, v) for k, v in overrides.items() if k not in _VMAPPABLE))


def run_sweep(
    base: Experiment,
    grid: Sequence[Dict[str, Any]],
    retries: int = 1,
    out_path: Optional[str] = None,
    group_seeds: bool = True,
    epochs: Optional[int] = None,
    devices: Optional[Sequence] = None,
    concurrent: Optional[bool] = None,
    device="cuda",
    dataset: Optional[str] = None,
) -> List[SweepResult]:
    """Run every configuration of ``grid`` on ``device``; returns one
    ``SweepResult`` per entry, in grid order (the JSONL rows stream in
    completion order). Groups that differ only in seed and rho run as one
    ensemble through the trainer's whole schedule; the others as solo units.
    ``devices`` and ``concurrent`` are JAX's: more than one unit over more
    than one card raises (slice 6)."""
    from pinns_tpu_torch.parallel.ensemble import SLICE_6, run_ensemble
    from pinns_tpu_torch.train.trainer import Trainer

    groups: Dict[tuple, List[Tuple[int, Dict]]] = {}
    for idx, overrides in enumerate(grid):
        groups.setdefault(_group_key(overrides), []).append((idx, overrides))

    units: List[Tuple[str, List[Tuple[int, Dict]]]] = []
    degraded: List[Tuple[int, str]] = []  # (configurations, reason)
    for members in groups.values():
        try:
            rad = override(base, members[0][1]).sampling.strategy == "rad"
        except (AttributeError, TypeError, ValueError):
            rad = None  # overrides that do not apply: their units fail and are recorded
        if (group_seeds and len(members) > 1 and rad is False
                and all(set(ov) & set(_VMAPPABLE) for _, ov in members)):
            units.append(("ensemble", members))
            continue
        if len(members) > 1:
            if not group_seeds:
                reason = "group_seeds=False"
            elif rad is None:
                reason = "the overrides do not apply to the preset"
            elif rad:
                reason = "sampling.strategy='rad' needs the solo train loop"
            else:
                reason = f"some members have no value-only axis ({', '.join(_VMAPPABLE)})"
            degraded.append((len(members), reason))
        units.extend(("solo", [m]) for m in members)

    cards = 1 if devices is None else len(devices)
    if (concurrent if concurrent is not None else True) and cards > 1 and len(units) > 1:
        raise NotImplementedError(f"{len(units)} sweep units over {cards} cards at once: "
                                  f"{SLICE_6}; pass concurrent=False to run them in turn")
    for n, reason in degraded:
        print(f"sweep: running {n} configs as serial units, one after another on one card "
              f"(concurrent units over cards: {SLICE_6}); not one ensemble: {reason}",
              flush=True)

    label = str(device)
    by_idx: Dict[int, SweepResult] = {}
    sink = open(out_path, "a") if out_path else None

    def emit(idx: int, res: SweepResult):
        by_idx[idx] = res
        if sink:
            sink.write(json.dumps(dataclasses.asdict(res)) + "\n")
            sink.flush()

    def run_unit(kind: str, members):
        exp0 = override(base, members[0][1])
        n_epochs = epochs if epochs is not None else exp0.train.epochs
        m0 = time.monotonic()
        if kind == "ensemble":
            t0 = time.time()
            try:
                trainer = Trainer(exp0, device=device, dataset=dataset)
                seeds = [ov.get("train.seed", exp0.train.seed) for _, ov in members]
                rhos = None
                if any("loss.rho" in ov for _, ov in members):
                    rhos = [ov.get("loss.rho", exp0.loss.rho) for _, ov in members]
                _, summaries = run_ensemble(trainer, seeds, rhos=rhos, epochs=n_epochs)
                dt, m1 = time.time() - t0, time.monotonic()
                for (idx, ov), s in zip(members, summaries):
                    emit(idx, SweepResult(ov, "ok", s, seconds=dt / len(seeds), device=label,
                                          t_start=m0, t_end=m1))
            except Exception:  # noqa: BLE001 -- recorded; the sweep goes on
                err = traceback.format_exc(limit=5)
                for idx, ov in members:
                    emit(idx, SweepResult(ov, "failed", error=err, device=label, t_start=m0,
                                          t_end=time.monotonic()))
            return
        ((idx, ov),) = members
        last_err = None
        for attempt in range(1, retries + 2):
            t0 = time.time()
            try:
                trainer = Trainer(override(base, ov), device=device, dataset=dataset)
                _, summary = trainer.train(epochs=n_epochs)
                emit(idx, SweepResult(ov, "ok", summary, seconds=time.time() - t0,
                                      attempts=attempt, device=label, t_start=m0,
                                      t_end=time.monotonic()))
                return
            except Exception:  # noqa: BLE001
                last_err = traceback.format_exc(limit=5)
        emit(idx, SweepResult(ov, "failed", error=last_err, attempts=retries + 1, device=label,
                              t_start=m0, t_end=time.monotonic()))

    try:
        for kind, members in units:
            try:
                run_unit(kind, members)
            except Exception:  # noqa: BLE001 -- e.g. an override key that does not exist
                err = traceback.format_exc(limit=5)
                for idx, ov in members:
                    emit(idx, SweepResult(ov, "failed", error=err, device=label))
    finally:
        if sink:
            sink.close()
    return [by_idx[i] for i in range(len(grid))]
