"""Hyperparameter sweeps (port of ``pinns_tpu/parallel/sweep.py``, the JAX
package's replacement for the reference's MPI master-worker farm).

The grid is the cartesian product of dotted-key override lists
(:func:`cartesian_grid`). Configurations that differ only in value axes
(``train.seed``, ``loss.rho``) form one ensemble unit
(``parallel.ensemble.run_ensemble``: on the card one K8 epoch for all its
members, replayed from captured graphs (K9), inside K3's narrow scope); any
other configuration is a
solo unit, retried ``retries`` times on failure. With more than one card and
more than one unit, the units run concurrently, one worker process a card,
each unit on its worker's card (``devices``, by default every visible card
when ``device`` is 'cuda', as JAX's default is every local device); on one
card they run in order, with a log line that says so. Every result is
recorded, failures included, in grid order, and streamed to a JSONL file
when ``out_path`` is given (in completion order).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import queue
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
    """Run every configuration of ``grid``; returns one ``SweepResult`` per
    entry, in grid order (the JSONL rows stream in completion order). Groups
    that differ only in seed and rho run as one ensemble through the
    trainer's whole schedule; the others as solo units. ``devices`` and
    ``concurrent`` are JAX's: the units are dispatched over ``devices``
    (device names; by default every visible card when ``device`` is 'cuda',
    else ``[device]``), one spawned worker process a device, when there
    are more than one of each and ``concurrent`` is not False; each
    result's ``device`` names where it ran. Otherwise they run in turn, in
    this process, on ``device``."""
    import torch

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

    if devices is None:
        devices = ([f"cuda:{k}" for k in range(torch.cuda.device_count())]
                   if str(device) == "cuda" and torch.cuda.is_available() else [str(device)])
    devices = [str(d) for d in devices]
    use_concurrent = ((concurrent if concurrent is not None else True) and len(devices) > 1
                      and len(units) > 1)
    for n, reason in degraded:
        how = "concurrent" if use_concurrent else "serial"
        print(f"sweep: running {n} configs as {how} units; not one ensemble: {reason}",
              flush=True)

    by_idx: Dict[int, SweepResult] = {}
    sink = open(out_path, "a") if out_path else None

    def emit(idx: int, res: SweepResult):
        by_idx[idx] = res
        if sink:
            sink.write(json.dumps(dataclasses.asdict(res)) + "\n")
            sink.flush()

    job = (base, retries, epochs, dataset)
    try:
        if use_concurrent:
            _run_over_devices(units, devices, job, emit)
        else:
            if len(units) > 1:
                print(f"sweep: running {len(units)} units serially on {device} (one device)",
                      flush=True)
            for u in units:
                for idx, res in _run_unit_safe(u, str(device), job):
                    emit(idx, res)
    finally:
        if sink:
            sink.close()
    return [by_idx[i] for i in range(len(grid))]


def _run_over_devices(units, devices, job, emit):
    """The units over ``devices``: one spawned worker process a device, each
    taking units from one queue until it is empty; every result is emitted
    here as it arrives. A unit whose worker died records that as its
    failure. Processes, not threads: each card captures its CUDA graphs in
    a process of its own, where no other card's allocations or syncs can
    break the capture."""
    import multiprocessing as mp

    n_workers = min(len(devices), len(units))
    print(f"sweep: dispatching {len(units)} units concurrently over {n_workers} devices "
          "(one worker process a device)", flush=True)
    ctx = mp.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    for i, unit in enumerate(units):
        tasks.put((i, unit))
    for _ in range(n_workers):
        tasks.put(None)
    procs = {d: ctx.Process(target=_device_worker, args=(d, job, tasks, results))
             for d in devices[:n_workers]}
    for p in procs.values():
        p.start()
    running: Dict[int, str] = {}  # unit -> the device that took it
    done = set()
    try:
        while len(done) < len(units):
            try:
                msg = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.is_alive() for p in procs.values()):
                    continue
                try:  # every worker has exited: what they sent last
                    msg = results.get(timeout=1.0)
                except queue.Empty:
                    break
            if msg[0] == "start":
                running[msg[1]] = msg[2]
                continue
            _, i, rows = msg
            done.add(i)
            for idx, res in rows:
                emit(idx, res)
    finally:
        for p in procs.values():
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for i, (_, members) in enumerate(units):
        if i in done:
            continue
        dev = running.get(i)
        err = (f"the worker process on {dev} exited with code {procs[dev].exitcode}"
               if dev is not None else "no worker process took this unit")
        for idx, ov in members:
            emit(idx, SweepResult(ov, "failed", error=err, device=dev))


def _device_worker(dev: str, job, tasks, results):
    """One device's worker process: units from ``tasks`` until the sentinel,
    each announced and its rows sent back."""
    while True:
        item = tasks.get()
        if item is None:
            return
        i, unit = item
        results.put(("start", i, dev))
        results.put(("done", i, _run_unit_safe(unit, dev, job)))


def _run_unit_safe(unit, dev: str, job) -> List[Tuple[int, SweepResult]]:
    """``unit`` run on ``dev`` (a device name; "cpu:k" names a CPU worker,
    its tensors on the one CPU device): its (grid index, result) rows.
    _run_unit records its own failures; this catches the rest (e.g. an
    override key that does not exist), so a unit never fails silently."""
    import torch

    try:
        card = torch.device("cpu" if dev.startswith("cpu") else dev)
        if card.type == "cuda" and card.index is not None:
            torch.cuda.set_device(card)
        return _run_unit(*unit, dev, job)
    except Exception:  # noqa: BLE001
        err = traceback.format_exc(limit=5)
        return [(idx, SweepResult(ov, "failed", error=err, device=dev)) for idx, ov in unit[1]]


def _run_unit(kind: str, members, label: str, job) -> List[Tuple[int, SweepResult]]:
    from pinns_tpu_torch.parallel.ensemble import run_ensemble
    from pinns_tpu_torch.train.trainer import Trainer

    base, retries, epochs, dataset = job
    device = "cpu" if label.startswith("cpu") else label
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
            return [(idx, SweepResult(ov, "ok", s, seconds=dt / len(seeds), device=label,
                                      t_start=m0, t_end=m1))
                    for (idx, ov), s in zip(members, summaries)]
        except Exception:  # noqa: BLE001 -- recorded; the sweep goes on
            err = traceback.format_exc(limit=5)
            return [(idx, SweepResult(ov, "failed", error=err, device=label, t_start=m0,
                                      t_end=time.monotonic())) for idx, ov in members]
    ((idx, ov),) = members
    last_err = None
    for attempt in range(1, retries + 2):
        t0 = time.time()
        try:
            trainer = Trainer(override(base, ov), device=device, dataset=dataset)
            _, summary = trainer.train(epochs=n_epochs)
            return [(idx, SweepResult(ov, "ok", summary, seconds=time.time() - t0,
                                      attempts=attempt, device=label, t_start=m0,
                                      t_end=time.monotonic()))]
        except Exception:  # noqa: BLE001
            last_err = traceback.format_exc(limit=5)
    return [(idx, SweepResult(ov, "failed", error=last_err, attempts=retries + 1, device=label,
                              t_start=m0, t_end=time.monotonic()))]
