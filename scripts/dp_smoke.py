"""Slice 6 on the card: data-parallel training over NCCL, one process a card.

    python -m torch.distributed.run --nproc-per-node N scripts/dp_smoke.py [--out F.json]

Every rank joins the NCCL process group (``parallel.mesh.multihost_init``,
the card ``LOCAL_RANK``); local rank 0 builds the kernels first. Then, with
one JSON line each (rank 0 prints; a check that fails on any rank raises and
fails the run):

  modes     K3's data-parallel modes on each rank's rows of one batch
            (abgrall_admm's 8x20 at N_f 1,000, N_u 100, 'admm'; the wide
            design at 8x200, 'l1_sq_norm'): the reduce mode against its
            plain version (``dp_reduce_reference``, within MODE_TOL of
            max|plain| per part), the NCCL all-reduce of the sums and the
            summed sums against one reduce launch over the whole batch (the
            gradient's and the loss's sums, within MODE_TOL), the apply
            mode against its plain version (``dp_apply_reference``) bit for
            bit; each mode timed by CUDA events beside its plain version
            and its bound
  draws     each rank's K11 draw at its row offset, gathered: bit-equal to
            one K11 launch of the whole batch (N_f 1,000 and 1,048,576)
  main      abgrall_admm through ``Trainer.train`` under ``--mesh-data N``'s
            path (``shard_trainer``): DP_EPOCHS Adam epochs replayed from
            K9's graphs with the NCCL all-reduces captured in them (every
            launch and collective counted from zero just before), every
            rank's loss equal, then L-BFGS outer epochs on DeviceLBFGS (K3's
            value-and-grad split around an all-reduce captured in a graph of
            16 steps replayed until the done flag is set, SolveReplay; at
            one rank bit-equal to the one-card outer epochs, one launch of
            the solve's WHILE node each);
            at one rank the chunk bit-equal to the non-DP chunk (params,
            batch, z, dual, every metric); at more, the gathered batch
            bit-equal to the one-card run's on rank 0 and the params within
            DRIFT_TOL of it; at every world one graphed epoch's gradient and
            loss held to the one-card epoch on the same whole batch
  generic   burgers_forward's generic step (K1, K2, K5, K11) data-parallel
            through K9's generic runner, its NCCL all-reduce captured in the
            epoch's graph: every epoch replayed, one all-reduce an epoch, the
            ranks' losses equal; at one rank the params bit-equal to the
            one-card run's, at more the u rel-L2 printed beside it (its float32
            sums run in another order; tests/test_torch_dp.py holds the
            data-parallel trajectory to the one-process one in float64); one
            graphed epoch's gradient and loss held to the one-card epoch
  autograd_lbfgs  burgers_inverse's L-BFGS outer epochs on AutogradLBFGS over
            the all-reduced objective, host-stepped by configuration (the
            all-reduce does not go into the solve's WHILE node): the ranks'
            losses equal; at one rank bit-equal to the one-card outer epochs
            (captured)
  scale     burgers_scale at 1,048,576 points (its 128 microbatches on
            each rank's 1,048,576 / N rows): SCALE_EPOCHS epochs timed one
            by one, their median, least and most
  ensemble  euler_weak_fast --ensemble 8, members over the ranks (data axis
            1): a chunk of epochs timed, no collective in it

The last line printed by rank 0 is ``{"dp_smoke": {...}}`` with every
number, the card's name and power limit (nvidia-smi) and the world size;
``--out`` writes the same object to a file. ``chip_smoke.py`` runs this
script as one of its phases and reads that file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the smoke's helpers: points, timers, bounds)

MODE_TOL = 1e-4  # the reduce mode's sums against the plain version's, of max|plain| a part
# the final params of DP_EPOCHS data-parallel Adam epochs against the one-card
# run's (float32 sums in another order): 4.6e-7 and 4.8e-7 read on 2 and 4
# H100s, held to twenty times that
DRIFT_TOL = 1e-5
DP_EPOCHS = 2_000  # the main path's Adam epochs (two chunks of DP_CHUNK)
DP_CHUNK = 1_000
DP_OUTER = 2  # its L-BFGS outer epochs after the switch
DP_LBFGS_ITERS = 30
AG_ADAM = 200  # burgers_inverse's Adam epochs before its DP L-BFGS outer epochs
TIMED_CHUNK = 500  # the DP chunk timed, TIMED_TURNS times
TIMED_TURNS = 3
SCALE_EPOCHS = 10  # burgers_scale epochs timed one by one after one warm-up epoch
ENS_MEMBERS, ENS_EPOCHS = 8, 50  # euler_weak_fast's member-sharded chunk
GENERIC_EPOCHS, GENERIC_CHUNK = 300, 100  # burgers_forward's data-parallel Adam epochs
K11_NS = (1_000, 1_048_576)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def gather(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def sync():
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def mode_inputs(layers, kind: str, rank: int, world: int, device):
    """A rank's rows of one 1,000-point batch, its z and dual, the 100 data
    points and a seeded net, as flat (1, ...) tensors."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params

    spec = MLPSpec(layers=layers, lb=cs.LB, ub=cs.UB)
    n = 1_000 // world
    rows = slice(rank * n, (rank + 1) * n)
    colloc = cs.points(1_000, seed=11, device=device)[rows].contiguous()
    rng = np.random.default_rng(12)
    z = torch.from_numpy((0.1 * rng.standard_normal((1_000, 1))).astype(np.float32))
    dual = torch.from_numpy((1.0 + 0.1 * rng.standard_normal((1_000, 1))).astype(np.float32))
    x_data = cs.points(100, seed=13, device=device)
    u_data = torch.sin(3.0 * x_data[:, :1]).contiguous()
    params = pack_params(init_mlp(spec, torch.Generator().manual_seed(14), device))
    mu = 0.01 * torch.ones_like(params)
    nu = 1e-4 * torch.ones_like(params)
    admm = kind == "admm"
    return spec, dict(params=params[None], mu=mu[None], nu=nu[None], x_data=x_data,
                      u_data=u_data, colloc=colloc[None],
                      z=z[rows].to(device)[None] if admm else None,
                      dual=dual[rows].to(device)[None] if admm else None)


def phase_modes(rank: int, world: int, shard, device) -> dict:
    """K3's reduce and apply modes against their plain versions, timed."""
    from pinns_tpu_torch.ops.kernels import fused_step as kf
    from pinns_tpu_torch.opt.adam import bias_corrections

    out = {}
    for name, layers, kind in (("narrow_8x20", cs.NARROW, "admm"),
                               ("wide_8x200", cs.WIDE, "l1_sq_norm")):
        spec, t = mode_inputs(layers, kind, rank, world, device)
        P, n_local = spec.n_params, t["colloc"].shape[1]
        cfg = dict(kind=kind, lam1=1.0, lam2=0.0, lr=1e-3, explicit_inner=False)
        rho = 10.0
        sums = torch.zeros(2 * P + 3, dtype=torch.float64, device=device)
        common = dict(sums=sums, n_f_all=n_local * world, row0=rank * n_local,
                      data_tiles=int(rank == 0))
        count = 7
        res_out = {}

        def call(mode, out=None):
            return kf._epoch(spec, 1, t["params"], t["mu"], t["nu"], count, t["x_data"],
                             t["u_data"], t["colloc"], t["z"], t["dual"], rho=rho, seed=1234,
                             epoch=8, out=out, dp=dict(common, mode=mode), **cfg)

        call("reduce")
        want = kf.dp_reduce_reference(spec, t["params"][0], t["x_data"], t["u_data"],
                                      t["colloc"][0], None if t["z"] is None else t["z"][0],
                                      None if t["dual"] is None else t["dual"][0], kind=kind,
                                      lam1=1.0, lam2=0.0, rho=rho, n_f_all=n_local * world,
                                      data_tiles=rank == 0)
        got = sums[:2 * P + 2].clone()
        errs = {}
        for part, sl in (("res", slice(0, P)), ("dat", slice(P, 2 * P)),
                         ("S", slice(2 * P, 2 * P + 1)), ("D", slice(2 * P + 1, 2 * P + 2))):
            g, w = got[sl].cpu().numpy(), want[sl].cpu().numpy()
            err = float(np.abs(g - w).max())
            scale = float(np.abs(w).max())
            cs.check(bool(np.isfinite(g).all()) and err <= MODE_TOL * scale + 1e-30,
                     f"{name} reduce {part}: max|kernel - plain| {err} > {MODE_TOL} x {scale}")
            errs[part] = err
        res_out["reduce_max_abs_err"] = max(errs.values())
        shard.all_reduce(sums[:2 * P + 2])
        summed = sums.clone()
        # the all-reduced sums against one launch over the whole batch
        _, w = mode_inputs(layers, kind, 0, 1, device)
        whole = torch.zeros_like(sums)
        kf._epoch(spec, 1, w["params"], w["mu"], w["nu"], count, w["x_data"], w["u_data"],
                  w["colloc"], w["z"], w["dual"], rho=rho, seed=1234, epoch=8,
                  dp=dict(sums=whole, n_f_all=1_000, row0=0, data_tiles=1, mode="reduce"),
                  **cfg)
        res_out["whole_batch_max_abs_err"] = max(
            whole_err(summed[sl], whole[sl], f"{name}: the all-reduced {part} sums")
            for part, sl in (("res", slice(0, P)), ("dat", slice(P, 2 * P)),
                             ("S", slice(2 * P, 2 * P + 1)), ("D", slice(2 * P + 1, 2 * P + 2))))
        r = call("apply")
        torch.cuda.synchronize()
        bc1, bc2 = bias_corrections(count)
        want_p, want_m, want_v, want_metrics = kf.dp_apply_reference(
            summed, t["params"][0], t["mu"][0], t["nu"][0], kind=kind, lr=1e-3, bc1=bc1,
            bc2=bc2, n_u=100, n_f_all=n_local * world, lam1=1.0, lam2=0.0)
        for what, g, w in (("params", r["params"][0], want_p), ("mu", r["mu"][0], want_m),
                           ("nu", r["nu"][0], want_v)):
            cs.check(torch.equal(g, w.to(g.device)), f"{name} apply {what} differs from plain: "
                     f"max {float((g - w.to(g.device)).abs().max())}")
        keep = [1, 2, 3, 4, 5, 6]  # every metric but the misfit (the finalize mode's)
        cs.check(torch.equal(r["metrics"][0][keep], want_metrics.to(device)[keep]),
                 f"{name} apply metrics {r['metrics'][0].tolist()} != {want_metrics.tolist()}")
        res_out["apply_max_abs_err"] = 0.0
        # times: each mode by CUDA events beside its plain version on the card
        sums.copy_(summed)
        res_out["reduce_ms"] = cs.event_ms(lambda: call("reduce"))
        res_out["reduce_plain_ms"] = cs.event_ms(lambda: kf.dp_reduce_reference(
            spec, t["params"][0], t["x_data"], t["u_data"], t["colloc"][0],
            None if t["z"] is None else t["z"][0], None if t["dual"] is None else t["dual"][0],
            kind=kind, lam1=1.0, lam2=0.0, rho=rho, n_f_all=n_local * world,
            data_tiles=rank == 0))
        sums.copy_(summed)
        buf = {k: torch.empty_like(v) if v is not None else None for k, v in r.items()
               if k in ("params", "mu", "nu", "colloc", "z", "dual")}
        res_out["apply_ms"] = cs.event_ms(lambda: call("apply", out=buf))
        res_out["apply_plain_ms"] = cs.event_ms(lambda: kf.dp_apply_reference(
            summed, t["params"][0], t["mu"][0], t["nu"][0], kind=kind, lr=1e-3, bc1=bc1,
            bc2=bc2, n_u=100, n_f_all=n_local * world, lam1=1.0, lam2=0.0))
        res_out["reduce_bound"] = reduce_bound(layers, n_local, 100 if rank == 0 else 0)
        res_out["apply_bound"] = apply_bound(layers, n_local, kind)
        res_out["n_local"] = n_local
        out[name] = res_out
    return out


def whole_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max|got - want|, checked within MODE_TOL of max|want| (float32 partial
    sums in another order) and returned."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    cs.check(bool(torch.isfinite(got).all()) and err <= MODE_TOL * scale,
             f"{what} differ from the one-card sums over the whole batch: max "
             f"{err} > {MODE_TOL} x {scale}")
    return err


def first_epoch_err(trainer, solo, state0, what: str):
    """One epoch of ``trainer``'s graphed chunk (every rank; its collectives
    captured) against one of the one-card ``solo`` trainer's from its own
    initial state, on data rank 0: Adam's first moment after one step from
    zero is a tenth of the all-reduced gradient, so it and the epoch's loss
    are held to the one-card epoch on the same whole batch (``whole_err``).
    Returns (max|dmu|, |dloss|) on rank 0, else None."""
    from pinns_tpu_torch.opt.adam import tree_leaves

    state, m = trainer._get_chunk("adam")(state0, 1)
    if solo is None:
        return None
    s_state, s_m = solo._get_chunk("adam")(solo.init_state(), 1)
    mu = torch.cat([v.reshape(-1) for v in tree_leaves(state.opt_state.mu["net"])])
    s_mu = torch.cat([v.reshape(-1) for v in tree_leaves(s_state.opt_state.mu["net"])])
    return (whole_err(mu, s_mu, f"{what}: one epoch's gradients"),
            whole_err(m["loss"][:1].double(), s_m["loss"][:1].double(),
                      f"{what}: one epoch's loss"))


def reduce_bound(layers, n_f: int, n_u: int):
    """The reduce mode: the grad kernel's work (``chip_smoke.narrow_grad_bound``)
    and its sums written once (16 bytes a parameter)."""
    ops = cs.taylor2_ops(layers, n_f) * 3 + [(3 * 2.0 * sum(cs._macs(layers)) * n_u,
                                               cs.PEAK_FP32)]
    nbytes = 8 * cs.n_params(layers) + 16 * n_f + 12 * n_u + 16 * cs.n_params(layers) + 16
    return cs.bound(ops, nbytes)


def apply_bound(layers, n_f: int, kind: str):
    """The apply mode: Adam over the summed sums (read 16 bytes a parameter,
    the params and moments read and written) and the tail's Taylor-2 forward
    at the rank's new points (the points, z and dual written)."""
    ops = cs.taylor2_ops(layers, n_f) if kind == "admm" else []
    nbytes = 16 * cs.n_params(layers) + 24 * cs.n_params(layers) + 20 * n_f
    return cs.bound(ops, nbytes)


def phase_draws(rank: int, world: int, device) -> dict:
    """K11 at each rank's row offset, gathered, against one launch of all."""
    import torch.distributed as dist

    from pinns_tpu_torch.ops.kernels import sampling
    from pinns_tpu_torch.train import schedule

    out = {}
    rows = schedule.schedule_rows(1234, 0, 41, 1, 0.0, lambda e: (cs.LB, cs.UB))
    sched = schedule.to_device(rows, device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)
    for n in K11_NS:
        m = n // world
        mine = sampling.philox_draw(sched, cursor, m, torch.float32, rank * m)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        whole = sampling.philox_draw(sched, cursor, n, torch.float32)
        cs.check(torch.equal(torch.cat(parts), whole), f"K11: the ranks' draws of {n} points "
                 "differ from one launch")
        out[str(n)] = {"rows_per_rank": m, "bit_equal": True}
    return out


def dp_exp(epochs: int, **extra):
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset

    return override(get_preset("abgrall_admm"), {
        "train.epochs": epochs, "train.chunk": DP_CHUNK, "train.log_every": 0,
        "optimizer.switch_epoch": DP_EPOCHS, "optimizer.lbfgs.max_iters": DP_LBFGS_ITERS,
        **extra})


def phase_main(rank: int, world: int, mesh, device) -> dict:
    """abgrall_admm's training under data parallelism: the graphed Adam
    chunks with NCCL captured, then L-BFGS outer epochs."""
    from pinns_tpu_torch.ops.kernels import fused_step as kf
    from pinns_tpu_torch.ops.kernels import generic_chunk, lbfgs, sampling
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.train.trainer import Trainer

    trainer = Trainer(dp_exp(DP_EPOCHS), device=device)
    sharding.shard_trainer(trainer, mesh)
    state0 = trainer.init_state()
    for m, names in ((kf, ("LAUNCHES", "GRAPH_EPOCHS", "GRAPH_REPLAYS", "DP_REDUCE_LAUNCHES",
                           "DP_APPLY_LAUNCHES", "VALUE_AND_GRAD_LAUNCHES")),
                     (sampling, ("LAUNCHES",)), (generic_chunk, ("GRAPH_EPOCHS",))):
        for name in names:
            setattr(m, name, 0)
    sharding.reset_collectives()
    sync()
    t0 = time.perf_counter()
    state, summary = trainer.train(state0)
    sync()
    wall = time.perf_counter() - t0
    counts = {"dp_reduce": kf.DP_REDUCE_LAUNCHES, "dp_apply": kf.DP_APPLY_LAUNCHES,
              "graph_epochs": kf.GRAPH_EPOCHS, "graph_replays": kf.GRAPH_REPLAYS,
              "host_calls": kf.LAUNCHES, "collectives": sharding.collective_counts()}
    cs.check(counts["dp_reduce"] == DP_EPOCHS and counts["dp_apply"] == DP_EPOCHS,
             f"DP main path: reduce/apply launches {counts}")
    cs.check(counts["graph_epochs"] == DP_EPOCHS and counts["host_calls"] == 0,
             f"DP main path: epochs outside K9's graphs {counts}")
    # two an epoch, and two in each capture's warm-up epoch (a real epoch,
    # on the runner's buffers)
    captures = len(trainer._get_chunk("adam").runner.capture_seconds)
    counts["captures"] = captures
    cs.check(counts["collectives"].get("all_reduce", 0) == 2 * (DP_EPOCHS + captures),
             f"DP main path: all-reduces {counts['collectives']}, {captures} captures")
    losses = gather(summary["loss"])
    cs.check(all(v == losses[0] for v in losses) and np.isfinite(losses[0]),
             f"the ranks' losses differ: {losses}")
    if rank == 0:
        cs.check(np.isfinite(summary["rel_l2_u"]), f"rel-L2 {summary}")
    out = {"epochs": DP_EPOCHS, "wall_s": wall, "loss": losses[0], "counts": counts,
           "rel_l2_u": summary.get("rel_l2_u")}
    # the chunk timed: TIMED_CHUNK epochs a turn, by CUDA events
    run = trainer._get_chunk("adam")
    times = []
    for _ in range(TIMED_TURNS):
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(state0, TIMED_CHUNK)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_CHUNK)
    out["ms_per_epoch"] = float(np.median(times))
    # against the one-card run: at one rank bit for bit (the final state,
    # then one more chunk's metrics), at more the gathered batch on rank 0
    leaves = lambda st: ([st.colloc, st.admm.z, st.admm.dual]  # noqa: E731
                         + [v for layer in st.params["net"] for v in layer.values()])
    whole = sharding.gather_state(state, trainer.problem.shard)
    solo = Trainer(dp_exp(DP_EPOCHS), device=device) if rank == 0 else None
    if rank == 0:
        s_state, _ = solo.train(solo.init_state())
        if world == 1:
            same = all(torch.equal(a, b) for a, b in zip(leaves(s_state), leaves(state)))
            s_m = solo._get_chunk("adam")(s_state, 7)[1]
            d_m = trainer._get_chunk("adam")(state, 7)[1]
            cs.check(same and all(torch.equal(s_m[k], d_m[k]) for k in s_m),
                     "at one rank the DP chunk differs from the one-card chunk")
            out["world1_bit_equal"] = True
        cs.check(torch.equal(whole.colloc, s_state.colloc),
                 "the ranks' batches differ from the one-card batch")
        out["batch_bit_equal"] = True
        drift = float(max((a - b).abs().max()
                          for a, b in zip(leaves(whole)[3:], leaves(s_state)[3:])))
        cs.check(drift <= DRIFT_TOL, f"after {DP_EPOCHS} epochs the DP params are {drift} "
                 f"from the one-card run's (bound {DRIFT_TOL})")
        out["one_card_param_max_abs_diff"] = drift
    errs = first_epoch_err(trainer, solo, state0, "DP main path")
    if rank == 0:
        out["first_epoch_grad_max_abs_err"], out["first_epoch_loss_abs_err"] = errs
    # the L-BFGS phase (AutogradLBFGS over the all-reduced objective)
    hybrid = Trainer(dp_exp(DP_EPOCHS + DP_OUTER), device=device)
    sharding.shard_trainer(hybrid, mesh)
    lbfgs.SOLVES = lbfgs.SHARD_REPLAYS = 0
    h_state, h_sum = hybrid.train(state)
    sync()
    h_losses = gather(h_sum["loss"])
    cs.check(all(v == h_losses[0] for v in h_losses) and np.isfinite(h_losses[0]),
             f"L-BFGS: the ranks' losses differ: {h_losses}")
    solver = type(hybrid._lbfgs_step.solver).__name__
    cs.check(solver == "DeviceLBFGS" and lbfgs.SOLVES == DP_OUTER
             and lbfgs.SHARD_REPLAYS >= DP_OUTER,
             f"L-BFGS under data parallelism: {solver}, {lbfgs.SOLVES} solves, "
             f"{lbfgs.SHARD_REPLAYS} replays")
    out["lbfgs"] = {"outer_epochs": DP_OUTER, "loss": h_losses[0], "solves": lbfgs.SOLVES,
                    "replays": lbfgs.SHARD_REPLAYS, "solver": solver}
    if world == 1:  # the outer epochs bit-equal to the one-card step's
        ref = Trainer(dp_exp(DP_EPOCHS + DP_OUTER), device=device)
        r_state = state
        for _ in range(DP_OUTER):
            r_state, _ = ref._lbfgs_step(r_state)
        cs.check(all(torch.equal(a, b) for a, b in zip(leaves(r_state), leaves(h_state))),
                 "at one rank the data-parallel L-BFGS outer epochs differ from the one-card's")
        out["lbfgs"]["world1_bit_equal"] = True
    return out


def phase_generic(rank: int, world: int, mesh, device) -> dict:
    """burgers_forward's generic Adam epochs under data parallelism, replayed
    from K9's generic graph with the all-reduce captured in it."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import generic_chunk
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("burgers_forward"), {
        "train.epochs": GENERIC_EPOCHS, "train.chunk": GENERIC_CHUNK, "train.log_every": 0})
    trainer = Trainer(exp, device=device)
    sharding.shard_trainer(trainer, mesh)
    state0 = trainer.init_state()
    generic_chunk.GRAPH_EPOCHS = 0
    sharding.reset_collectives()
    sync()
    t0 = time.perf_counter()
    state, summary = trainer.train(state0)
    sync()
    wall = time.perf_counter() - t0
    captures = len(trainer._get_chunk("adam").runner.capture_seconds)
    counts = {"graph_epochs": generic_chunk.GRAPH_EPOCHS, "captures": captures,
              "collectives": sharding.collective_counts()}
    cs.check(counts["graph_epochs"] == GENERIC_EPOCHS,
             f"generic DP: epochs outside K9's generic graph {counts}")
    cs.check(counts["collectives"].get("all_reduce", 0) == GENERIC_EPOCHS + captures,
             f"generic DP: all-reduces {counts}")
    losses = gather(summary["loss"])
    cs.check(all(v == losses[0] for v in losses) and np.isfinite(losses[0]),
             f"generic DP: the ranks' losses differ: {losses}")
    out = {"preset": "burgers_forward", "epochs": GENERIC_EPOCHS, "wall_s": wall,
           "loss": losses[0], "counts": counts}
    solo = Trainer(exp, device=device) if rank == 0 else None
    if rank == 0:
        s_state, s_sum = solo.train(solo.init_state())
        out["one_card_rel_l2_u"], out["rel_l2_u"] = s_sum["rel_l2_u"], summary["rel_l2_u"]
        if world == 1:  # the one-card run's bits; at more ranks float32 sums in another order
            same = all(torch.equal(a, b) for a, b in zip(
                [v for layer in s_state.params["net"] for v in layer.values()],
                [v for layer in state.params["net"] for v in layer.values()]))
            cs.check(same, "generic DP at one rank differs from the one-card run")
            out["world1_bit_equal"] = True
    errs = first_epoch_err(trainer, solo, state0, "generic DP")
    if rank == 0:
        out["first_epoch_grad_max_abs_err"], out["first_epoch_loss_abs_err"] = errs
    return out


def phase_autograd_lbfgs(rank: int, world: int, mesh, device) -> dict:
    """burgers_inverse's L-BFGS outer epochs under data parallelism: the
    solver AutogradLBFGS over the all-reduced objective
    (``sharding.global_objective``) on its host-stepped drive, chosen by the
    configuration (``lbfgs.autograd_capture_refusals``: the all-reduce does
    not go into the body of the solve's WHILE node), no loop launched; every
    rank's loss equal; at one rank bit-equal to the one-card outer epochs,
    whose solves are one launch of the loop each."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs
    from pinns_tpu_torch.opt.lbfgs import ravel_tree
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("burgers_inverse"), {
        "train.epochs": AG_ADAM + DP_OUTER, "optimizer.switch_epoch": AG_ADAM,
        "optimizer.lbfgs.max_iters": DP_LBFGS_ITERS, "train.log_every": 0})
    trainer = Trainer(exp, device=device)
    sharding.shard_trainer(trainer, mesh)
    state0 = trainer.init_state()
    state, _ = trainer.train(state0, epochs=AG_ADAM)
    solver = trainer._lbfgs_step.solver
    cs.check(type(solver).__name__ == "AutogradLBFGS" and not solver.captured,
             f"burgers_inverse's DP solver {solver!r}")
    before = (lbfgs.SOLVES, lbfgs.LOOP_LAUNCHES)
    sync()
    t0 = time.perf_counter()
    h_state, h_sum = trainer.train(state)
    sync()
    wall = time.perf_counter() - t0
    counts = [a - b for a, b in zip((lbfgs.SOLVES, lbfgs.LOOP_LAUNCHES), before)]
    cs.check(counts == [DP_OUTER, 0], f"DP AutogradLBFGS: solves and loop launches {counts}")
    losses = gather(h_sum["loss"])
    cs.check(all(v == losses[0] for v in losses) and np.isfinite(losses[0]),
             f"DP AutogradLBFGS: the ranks' losses differ: {losses}")
    out = {"preset": "burgers_inverse", "adam_epochs": AG_ADAM, "outer_epochs": DP_OUTER,
           "loss": losses[0], "wall_s": wall, "solves": counts[0]}
    if world == 1:
        ref = Trainer(exp, device=device)
        r_state, _ = ref.train(state0, epochs=AG_ADAM)
        r_state, _ = ref.train(r_state)
        cs.check(torch.equal(ravel_tree(r_state.params)[0], ravel_tree(h_state.params)[0])
                 and torch.equal(r_state.colloc, h_state.colloc),
                 "at one rank the data-parallel AutogradLBFGS outer epochs differ from the "
                 "one-card's")
        out["world1_bit_equal"] = True
    return out


def phase_scale(rank: int, world: int, mesh, device) -> dict:
    """burgers_scale's float32 epoch, data-parallel: each rank's 1,048,576 /
    N rows in the preset's 128 microbatches (K1, K2 and K5 per rank)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("burgers_scale"), {"train.log_every": 0})
    trainer = Trainer(exp, device=device)
    sharding.shard_trainer(trainer, mesh)
    state = trainer.init_state()
    run = trainer._get_chunk("adam")
    state, m = run(state, 1)
    times = []
    for _ in range(SCALE_EPOCHS):
        sync()
        t0 = time.perf_counter()
        state, m = run(state, 1)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    losses = gather(float(m["loss"][-1]))
    cs.check(all(v == losses[0] for v in losses) and np.isfinite(losses[0]),
             f"burgers_scale: the ranks' losses differ: {losses}")
    return {"n_f": exp.sampling.n_f, "rows_per_rank": exp.sampling.n_f // world,
            "microbatch": exp.sampling.microbatch, "epochs": SCALE_EPOCHS,
            "ms_per_epoch": float(np.median(times)), "ms_min": min(times), "ms_max": max(times),
            "loss": losses[0], "clock": "host, each epoch between a device sync and a barrier"}


def phase_ensemble(rank: int, world: int, device) -> dict:
    """euler_weak_fast --ensemble 8 with its members over the ranks (data
    axis 1): one chunk of ENS_EPOCHS epochs of this rank's members timed."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.parallel.ensemble import (
        init_ensemble_states,
        make_ensemble_chunk,
        mesh_members,
    )
    from pinns_tpu_torch.parallel.mesh import make_mesh
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("euler_weak_fast"), {"train.log_every": 0})
    mesh = make_mesh(data=1, ensemble=world)
    ids = mesh_members(ENS_MEMBERS, mesh)
    trainer = Trainer(exp, device=device)
    stacked = init_ensemble_states(trainer, [exp.train.seed + i for i in ids])
    run = make_ensemble_chunk(trainer, ENS_EPOCHS)
    stacked, _ = run(stacked)  # the warm-up: captures
    sharding.reset_collectives()
    sync()
    t0 = time.perf_counter()
    stacked, m = run(stacked)
    torch.cuda.synchronize()
    mine = time.perf_counter() - t0
    sync()
    wall = time.perf_counter() - t0
    cs.check(sharding.collective_counts() == {}, "a member-sharded chunk issued collectives")
    cs.check(bool(torch.isfinite(m["loss"]).all()), "euler_weak_fast: non-finite loss")
    return {"members": ENS_MEMBERS, "members_per_rank": len(ids), "epochs": ENS_EPOCHS,
            "ms_per_epoch": 1e3 * wall / ENS_EPOCHS,
            "slowest_rank_ms_per_epoch": 1e3 * max(gather(mine)) / ENS_EPOCHS,
            "collectives": 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import torch.distributed as dist

    from pinns_tpu_torch.ops.kernels import build
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.parallel.mesh import make_mesh, multihost_init

    rank, world, name = multihost_init("cuda")
    device = torch.device(name)
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        build.prebuild(cs.KERNELS)
    dist.barrier()
    name = card()
    mesh = make_mesh(data=world, ensemble=1)
    shard = sharding.DataShard(rank=mesh.coords[1], size=world, group=mesh.data_group)
    result = {"world": world, "card": name, "device_name": torch.cuda.get_device_name(device)}
    phases = (("modes", lambda: phase_modes(rank, world, shard, device)),
              ("draws", lambda: phase_draws(rank, world, device)),
              ("main", lambda: phase_main(rank, world, mesh, device)),
              ("generic", lambda: phase_generic(rank, world, mesh, device)),
              ("autograd_lbfgs", lambda: phase_autograd_lbfgs(rank, world, mesh, device)),
              ("scale", lambda: phase_scale(rank, world, mesh, device)),
              ("ensemble", lambda: phase_ensemble(rank, world, device)))
    for phase, fn in phases:
        t0 = time.perf_counter()
        result[phase] = fn()
        result[phase]["phase_s"] = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({"phase": phase, **result[phase], "world": world, "card": name}),
                  flush=True)
    dist.barrier()
    if rank == 0:
        print(json.dumps({"dp_smoke": result}), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(result, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
