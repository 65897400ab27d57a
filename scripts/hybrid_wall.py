"""The hybrid phase's L-BFGS outer epochs on the card, K10 beside the host
loop: ``abgrall_admm`` trained for ``--adam`` Adam epochs (K3 in K9's
graphs), then from that one state ``--outer`` L-BFGS outer epochs of at most
``--max-iters`` iterations each, in turns: the trainer's per-outer-epoch step
(K10, ``ops.kernels.lbfgs.DeviceLBFGS``, the tail on K1 and K5: ``k10``), the
host loop (``train.trainer.make_lbfgs_step(host_loop=True)``: ``opt.lbfgs``
over the kernels under autograd: ``host``) and the trainer's chunks of outer
epochs (``ops.kernels.lbfgs.LBFGSChunk``, K3's post-update mode as the tail:
``runner``). The defaults are ``chip_smoke.py`` phase 14's schedule (the
fixture's: 10,000 Adam epochs, 10 outer epochs of at most 300 iterations).

    python scripts/hybrid_wall.py [--adam 10000] [--outer 10] [--max-iters 300]
        [--turns k10,host,k10,split,runner,runner_split] [--out FILE]

Prints one JSON line a turn: the wall seconds of the outer epochs (host
clock, ending in a synchronize), each outer epoch's iterations, the seconds
an iteration, the host syncs of the solves (``opt.lbfgs.HOST_SYNCS``), the
final u rel-L2, and the card's name and power limit. Needs one
NVIDIA GPU; imports no jax. ``--out`` also writes the lines as one JSON
list.

A ``split`` turn runs K10's outer epochs with each piece of the step
bracketed by synchronizes and timed on the host clock: ``ravel_tree``, the
solve's set-up (``DeviceLBFGS.minimize`` up to its loop's launch: the
batch, z and dual copies, the reset launch, and the loop's capture in the
first outer epoch), its launch and done-flag read, ``_post_update`` (the
resample and the z/dual update through K1) and the rest of the step (the
unravel, the data term through K5, the metrics). It prints each piece's
milliseconds an outer epoch (median and all), the outer epoch's own, and
the iterations. Each piece's time is synchronized wall time: its host work
and the device time of what it launched (K1 and K5 in ``_post_update`` and
the rest), not separated, plus the cost of the synchronizes themselves.

A ``runner_split`` turn runs the runner's chunks with each chunk and each
solve's launch (``SolveLoop.launch``) bracketed by
synchronizes, and prints the milliseconds an outer epoch of the chunks,
inside the solves and outside them (the post-update graph's replay, the
chunk's ravel, loads, reset and hand-back).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Pieces:
    """K10's outer epoch in timed pieces (a ``split`` turn): while entered,
    ``trainer.ravel_tree``, ``trainer._post_update``, ``solver.minimize`` and
    ``SolveLoop.launch`` are wrapped so that each call is
    bracketed by synchronizes and its host-clock milliseconds are added to
    the current outer epoch's row."""

    def __init__(self, solver):
        self.solver = solver
        self.rows = []
        self._saved = []

    @staticmethod
    def _now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    def _add(self, key: str, ms: float) -> None:
        if self.rows:  # a call outside an outer epoch is not counted
            self.rows[-1][key] = self.rows[-1].get(key, 0.0) + ms

    def _wrap(self, owner, name: str, key: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def timed(*a, **k):
            t0 = self._now()
            try:
                return fn(*a, **k)
            finally:
                self._add(key, 1e3 * (self._now() - t0))
        setattr(owner, name, timed)

    def __enter__(self):
        from pinns_tpu_torch.train import trainer as tr

        self._wrap(tr, "ravel_tree", "ravel_tree")
        self._wrap(tr, "_post_update", "post_update")
        from pinns_tpu_torch.ops.kernels.lbfgs import SolveLoop

        launch = SolveLoop.launch
        pieces = self

        def first_launch(loop):
            row = pieces.rows[-1] if pieces.rows else {}
            if "_minimize_t0" in row:  # minimize's entry to its loop's launch
                row["setup"] = 1e3 * (pieces._now() - row.pop("_minimize_t0"))
            return launch(loop)
        self._saved.append((SolveLoop, "launch", launch))
        SolveLoop.launch = first_launch
        minimize = self.solver.minimize

        def timed_minimize(*a, **k):
            t0 = self._now()
            self.rows[-1]["_minimize_t0"] = t0
            try:
                return minimize(*a, **k)
            finally:
                self._add("minimize", 1e3 * (self._now() - t0))
        self._saved.append((self.solver, "minimize", minimize))
        self.solver.minimize = timed_minimize
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        return False

    @contextlib.contextmanager
    def outer_epoch(self):
        self.rows.append({})
        t0 = self._now()
        yield
        row = self.rows[-1]
        row["outer_epoch"] = 1e3 * (self._now() - t0)
        row.pop("_minimize_t0", None)
        row.setdefault("setup", row["minimize"])  # a solve with no launch
        row["solve"] = row["minimize"] - row["setup"]
        row["rest"] = row["outer_epoch"] - row["ravel_tree"] - row["minimize"] - row["post_update"]

    def summary(self) -> dict:
        keys = ("outer_epoch", "ravel_tree", "setup", "solve", "post_update", "rest")
        return {k: {"median": statistics.median(r[k] for r in self.rows),
                    "all": [r[k] for r in self.rows]} for k in keys}


def runner_turn(trainer, state, turn: str, card: str, args) -> dict:
    """One turn on the trainer's chunks of outer epochs (LBFGSChunk); a
    ``runner_split`` turn also sums the solves' synchronized wall time."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    run = trainer._get_chunk("lbfgs")
    if not isinstance(getattr(run, "runner", None), k_lbfgs.LBFGSChunk):
        raise RuntimeError("abgrall_admm's L-BFGS phase is not on K10's chunk runner")
    iters, solve_ms, chunk_ms = [], [0.0], [0.0]

    def chunk(st, length, new_colloc=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = run(st, length, new_colloc)
        torch.cuda.synchronize()
        chunk_ms[0] += 1e3 * (time.perf_counter() - t0)
        iters.append(m["lbfgs_iters"])
        return st, m

    trainer._chunks["lbfgs"] = chunk
    launch = k_lbfgs.SolveLoop.launch

    def timed(loop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return launch(loop)
        finally:
            torch.cuda.synchronize()
            solve_ms[0] += 1e3 * (time.perf_counter() - t0)

    if turn == "runner_split":
        k_lbfgs.SolveLoop.launch = timed
    syncs = host_lbfgs.HOST_SYNCS
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, summary = trainer.train(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        k_lbfgs.SolveLoop.launch = launch
    iters = [int(v) for v in torch.cat(iters).tolist()] if iters else []
    row = {"turn": turn, "card": card, "adam_epochs": args.adam, "outer": len(iters),
           "max_iters": args.max_iters, "wall_s": wall, "lbfgs_iters": iters,
           "s_per_iter": wall / max(1, sum(iters)), "host_syncs": host_lbfgs.HOST_SYNCS - syncs,
           "rel_l2_u": summary["rel_l2_u"], "final_epoch": final.epoch}
    if turn == "runner_split":
        n = max(1, len(iters))
        row["ms_per_outer_epoch"] = {"outer_epoch": chunk_ms[0] / n, "solve": solve_ms[0] / n,
                                     "outside_solve": (chunk_ms[0] - solve_ms[0]) / n}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--adam", type=int, default=10_000)
    ap.add_argument("--outer", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--turns", default="k10,host,k10")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hybrid_wall: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.train.trainer import Trainer, make_lbfgs_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    base = get_preset("abgrall_admm")
    adam_exp = override(base, {"train.epochs": args.adam, "optimizer.switch_epoch": args.adam,
                               "train.log_every": 0})
    state, _ = Trainer(adam_exp, device="cuda").train()
    exp = override(base, {"train.epochs": args.adam + args.outer,
                          "optimizer.switch_epoch": args.adam,
                          "optimizer.lbfgs.max_iters": args.max_iters, "train.log_every": 0})
    rows = []
    for turn in args.turns.split(","):
        trainer = Trainer(exp, device="cuda")
        if turn in ("runner", "runner_split"):
            rows.append(runner_turn(trainer, state, turn, card, args))
            print(json.dumps(rows[-1]), flush=True)
            continue
        on_k10 = turn in ("k10", "split")
        step = trainer._lbfgs_step if on_k10 else make_lbfgs_step(trainer.problem,
                                                                  host_loop=True)
        if on_k10 and step.solver is None:
            raise RuntimeError("abgrall_admm's L-BFGS step is not on K10")
        iters = []
        pieces = Pieces(step.solver) if turn == "split" else None

        def counted(st, out=None, new_colloc=None, step=step, iters=iters, pieces=pieces):
            if pieces is None:
                st, m = step(st, out, new_colloc)
            else:
                with pieces.outer_epoch():
                    st, m = step(st, out, new_colloc)
            iters.append(int(m["lbfgs_iters"]))
            return st, m

        trainer._lbfgs_step = counted
        syncs = host_lbfgs.HOST_SYNCS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (pieces if pieces is not None else contextlib.nullcontext()):
            final, summary = trainer.train(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"turn": turn, "card": card, "adam_epochs": args.adam, "outer": len(iters),
               "max_iters": args.max_iters, "wall_s": wall, "lbfgs_iters": iters,
               "s_per_iter": wall / max(1, sum(iters)),
               "host_syncs": host_lbfgs.HOST_SYNCS - syncs,
               "rel_l2_u": summary["rel_l2_u"], "final_epoch": final.epoch}
        if pieces is not None:
            row["ms_per_outer_epoch"] = pieces.summary()
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
