"""Ensembles: E independent runs of one configuration trained together
(port of ``pinns_tpu/parallel/ensemble.py``, the JAX package's replacement
for the reference's MPI job farm, which swept ``Abgrall_ADMM.py`` over rho
and seeds).

JAX stacks the members' states along a leading axis and runs
``jax.vmap(step)`` under ``lax.scan``. The port keeps the same stacked
``TrainState`` (:func:`stack_states`): every tensor gains a leading member
axis, ``key`` holds the E Philox seeds and ``rho`` the E ADMM penalties (or
None: ``loss.rho`` for all). The net's params and Adam moments are views of
one (E, n_params) buffer each, in ``pack_params`` order, so that the
member-batched kernel takes them as they are
(``ops.kernels.fused_step.flat_net``).

An epoch of the ensemble (:func:`make_ensemble_chunk`) is
- on the card, for an Adam epoch inside K3's scope at the narrow widths
  (``abgrall_admm``, ``burgers_admm_batch``): one host call of K8, the
  member-batched fused Adam epoch (``ops.kernels.fused_step``);
- otherwise the member loop: each member's solo step in turn (the wide K3,
  the generic step over the kernels, the weak form, L-BFGS; the plain step
  on the CPU), each with its own seed and rho. JAX's vmapped L-BFGS leaves a
  converged member as it is, so each member's trajectory is its solo one.
Either way member i equals the solo run of its seed and rho bit for bit.

:func:`run_ensemble` runs the trainer's whole schedule (the hybrid switch
included) with per-member logs, snapshots, checkpoints and summaries;
:func:`selection_scores` and :func:`select_member` pick a member without
ground truth. Serving an ensemble (mean and std bands, calibration) comes
with slice 4b.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pinns_tpu_torch.device import pin_numerics
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops.kernels.taylor2 import net_from_leaves, net_leaves, pack_params
from pinns_tpu_torch.opt.adam import AdamState, tree_map
from pinns_tpu_torch.train.metrics import MetricsLogger
from pinns_tpu_torch.train.trainer import METRIC_KEYS, Trainer, TrainState

SLICE_2B = "slice 2b-iii (the rest of shock capture on the weak form)"
SLICE_6 = "slice 6 (multi-GPU)"


# -- the stacked state ---------------------------------------------------------

def _stack_net(nets) -> list:
    """Member nets as views of one (E, n_params) buffer."""
    template = nets[0]
    flat = torch.stack([pack_params(net) for net in nets])
    leaves, off = [], 0
    for t in net_leaves(template):
        leaves.append(flat[:, off:off + t.numel()].view(len(nets), *t.shape))
        off += t.numel()
    return net_from_leaves(leaves, int("path_c" in template[0]))


def _stack_tree(trees):
    """A params-shaped tree of members stacked: the net flat, the rest by torch.stack."""
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    return {k: _stack_net([t[k] for t in trees]) if k == "net"
            else tree_map(stack, *(t[k] for t in trees)) for k in trees[0]}


def stack_states(states: Sequence[TrainState]) -> TrainState:
    """Member ``TrainState``s as one stacked state (the inverse of
    :func:`unstack_states`). Members run in lockstep, as under vmap: they
    must agree on the epoch and on Adam's count. With the per-member
    checkpoints (``<name>_e{epoch}_m{i}.ckpt``) this resumes an ensemble:
    load each with ``Trainer.load_checkpoint``, stack, and pass the result as
    ``run_ensemble``'s ``stacked``."""
    if not states:
        raise ValueError("stack_states needs at least one member")
    s0 = states[0]
    for i, s in enumerate(states):
        if s.epoch != s0.epoch or s.opt_state.count != s0.opt_state.count:
            raise ValueError(
                f"member {i} is at epoch {s.epoch}, Adam count {s.opt_state.count}; member 0 "
                f"at {s0.epoch}, {s0.opt_state.count}: ensemble members run in lockstep")
        if (s.admm is None) != (s0.admm is None) or (s.rho is None) != (s0.rho is None):
            raise ValueError(f"member {i} differs from member 0 in its ADMM state or rho")
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    admm = None
    if s0.admm is not None:
        admm = ADMMState(z=tree_map(stack, *(s.admm.z for s in states)),
                         dual=tree_map(stack, *(s.admm.dual for s in states)))
    return TrainState(
        params=_stack_tree([s.params for s in states]),
        opt_state=AdamState(count=s0.opt_state.count,
                            mu=_stack_tree([s.opt_state.mu for s in states]),
                            nu=_stack_tree([s.opt_state.nu for s in states])),
        admm=admm,
        colloc=torch.stack([s.colloc for s in states]),
        key=tuple(int(s.key) for s in states),
        epoch=int(s0.epoch),
        rho=None if s0.rho is None else tuple(float(s.rho) for s in states),
    )


def unstack_states(stacked: TrainState, n: Optional[int] = None) -> List[TrainState]:
    """The members of a stacked state as ``TrainState``s whose tensors are
    views of the stacked ones."""
    n = len(stacked.key) if n is None else n

    def member(i):
        at = lambda t: t[i]  # noqa: E731
        opt = stacked.opt_state
        admm = stacked.admm
        return TrainState(
            params=tree_map(at, stacked.params),
            opt_state=AdamState(count=opt.count, mu=tree_map(at, opt.mu),
                                nu=tree_map(at, opt.nu)),
            admm=None if admm is None else ADMMState(z=tree_map(at, admm.z),
                                                     dual=tree_map(at, admm.dual)),
            colloc=stacked.colloc[i], key=int(stacked.key[i]), epoch=stacked.epoch,
            rho=None if stacked.rho is None else float(stacked.rho[i]),
        )

    return [member(i) for i in range(n)]


def _own(state: TrainState) -> TrainState:
    """A member state with tensors of its own, as a solo run holds them."""
    c = lambda t: t.clone()  # noqa: E731
    opt = state.opt_state
    return state._replace(
        params=tree_map(c, state.params),
        opt_state=AdamState(count=opt.count, mu=tree_map(c, opt.mu), nu=tree_map(c, opt.nu)),
        admm=None if state.admm is None else ADMMState(z=tree_map(c, state.admm.z),
                                                       dual=tree_map(c, state.admm.dual)),
        colloc=state.colloc.clone(),
    )


def init_ensemble_states(trainer: Trainer, seeds: Sequence[int],
                         rhos: Optional[Sequence[float]] = None) -> TrainState:
    """Each member initialized as a solo run of its seed (and its own ADMM
    rho when ``rhos`` is given), stacked."""
    if rhos is not None and len(rhos) != len(seeds):
        raise ValueError("rhos must match seeds length")
    return stack_states([
        trainer.init_state(seed=int(s), rho=None if rhos is None else float(rhos[i]))
        for i, s in enumerate(seeds)
    ])


def evaluate_ensemble(trainer: Trainer, stacked: TrainState, n: int) -> List[dict]:
    """Per-member final evaluation (rel-L2 per field), host side."""
    return [trainer.evaluate(s) for s in unstack_states(stacked, n)]


# -- stepping ------------------------------------------------------------------

def batched_on_card(trainer: Trainer) -> bool:
    """Whether an Adam epoch of this trainer's ensembles is one K8 call: on the
    card, inside K3's scope, at the narrow design's widths."""
    from pinns_tpu_torch.ops.kernels.fused_step import design, fused_step_supported

    problem = trainer.problem
    return (problem.device.type == "cuda" and not fused_step_supported(problem.exp, problem.spec)
            and design(problem.spec.layers) == "narrow")


def make_ensemble_chunk(trainer: Trainer, chunk: int, phase: str = "adam"):
    """``run(stacked, new_colloc=None) -> (stacked, {metric: (chunk, E)})``:
    ``chunk`` epochs of every member, the metrics in one (chunk, E, 7) device
    buffer with no host sync inside the chunk (the L-BFGS solve syncs in its
    line search, as a solo one does). ``phase`` is 'adam' or 'lbfgs' (one
    whole inner solve an epoch). ``new_colloc`` (chunk, E, N_f, 2) replaces
    the Philox draws (the tests feed JAX's batches)."""
    if trainer.exp.sampling.strategy == "rad":
        raise NotImplementedError(f"RAD resampling in an ensemble: {SLICE_2B}")
    if phase == "adam":
        step = trainer._adam_step
    elif phase == "lbfgs":
        step = trainer._lbfgs_step
    else:
        raise ValueError(f"unknown phase {phase!r}")
    batched = None
    if phase == "adam" and batched_on_card(trainer):
        from pinns_tpu_torch.ops.kernels.fused_step import make_fused_ensemble_step

        batched = make_fused_ensemble_step(trainer.problem, trainer.learning_rate)

    def run(stacked: TrainState, new_colloc: Optional[torch.Tensor] = None):
        n = len(stacked.key)
        buf = torch.empty((chunk, n, len(METRIC_KEYS)), dtype=torch.float32,
                          device=stacked.colloc.device)
        feed = (lambda t, i: None) if new_colloc is None else (  # noqa: E731
            lambda t, i: new_colloc[t] if i is None else new_colloc[t, i])
        if batched is not None:
            for t in range(chunk):
                stacked, _ = batched(stacked, buf[t], feed(t, None))
        else:
            members = [_own(m) for m in unstack_states(stacked, n)]
            for i in range(n):
                for t in range(chunk):
                    members[i], _ = step(members[i], buf[t, i], feed(t, i))
            stacked = stack_states(members)
        return stacked, {k: buf[:, :, j] for j, k in enumerate(METRIC_KEYS)}

    return run


# -- ground-truth-free selection -----------------------------------------------

def _primaries(problem, params, pts) -> Dict[str, torch.Tensor]:
    """The predicted primary fields at ``pts`` in float32 (the residual
    diagnostics f, f1..f3 are what resid_ms measures)."""
    from pinns_tpu_torch.train.evaluate import predict_fields

    return {k: v.to(torch.float32) for k, v in predict_fields(problem, params, pts).items()
            if not (k == "f" or (k[0] == "f" and k[1:].isdigit()))}


def scores_at(trainer: Trainer, stacked: TrainState, pts: torch.Tensor, n: Optional[int] = None,
              anchor_params=None) -> List[dict]:
    """:func:`selection_scores` at the given points (N, 2): one dict a member
    with ``data_term``, ``resid_ms``, ``score`` and, with ``anchor_params``
    (a stacked params tree), ``consensus``."""
    from pinns_tpu_torch.train.trainer import make_data_term

    problem = trainer.problem
    members = unstack_states(stacked, n)
    dterm = make_data_term(problem)
    w = float(problem.exp.loss.data_weight)
    d, ms = [], []
    with torch.no_grad():
        for m in members:
            d.append(dterm(m.params).to(torch.float32))
            res = problem.training_residuals(m.params, pts)
            res = res if isinstance(res, tuple) else (res,)
            ms.append(sum(torch.mean(torch.square(f.to(torch.float32))) for f in res) / len(res))
        d = torch.stack([t.reshape(()) for t in d]).cpu().numpy()
        ms = torch.stack([t.reshape(()) for t in ms]).cpu().numpy()
        consensus = None
        if anchor_params is not None:
            n_anchor = net_leaves(anchor_params["net"])[0].shape[0]
            anchor = [_primaries(problem, tree_map(lambda t, i=i: t[i], anchor_params), pts)
                      for i in range(n_anchor)]
            mean = {k: torch.mean(torch.stack([a[k] for a in anchor]), dim=0)
                    for k in anchor[0]}
            names = sorted(mean)
            norm = torch.linalg.vector_norm

            def dist(params):
                p = _primaries(problem, params, pts)
                per = [norm(p[k] - mean[k]) / (norm(mean[k]) + 1e-12) for k in names]
                return sum(per) / len(per)

            consensus = torch.stack([dist(m.params) for m in members]).cpu().numpy()
    return [
        {"member": i, "data_term": float(d[i]), "resid_ms": float(ms[i]),
         "score": float(w * d[i] + ms[i]),
         **({"consensus": float(consensus[i])} if consensus is not None else {})}
        for i in range(len(members))
    ]


def selection_scores(trainer: Trainer, stacked: TrainState, n: int, seed: int = 0,
                     n_points: int = 4096, anchor_params=None,
                     coarse_scales: Sequence[float] = ()) -> List[dict]:
    """Ground-truth-free per-member scores, as JAX's ``selection_scores``:
    ``data_term`` (the trained misfit on the training data), ``resid_ms`` (the
    mean square of the trained residual at one fresh uniform batch of
    ``n_points`` shared by all members, drawn with ``uniform_box`` from
    ``seed``), ``score`` = data_weight data_term + resid_ms, and
    ``consensus`` (the mean per-field relative-L2 distance to the anchor
    ensemble's mean prediction) when ``anchor_params`` is given. The draw is
    the port's own: JAX's threefry points differ."""
    if coarse_scales:
        raise NotImplementedError(f"the coarse-cell battery needs the entropy: {SLICE_2B}")
    from pinns_tpu_torch.data.sampling import uniform_box

    problem = trainer.problem
    pts = uniform_box(torch.Generator().manual_seed(int(seed)), n_points, problem.lb,
                      problem.ub, problem.spec.dtype, problem.device)
    return scores_at(trainer, stacked, pts, n, anchor_params)


def select_member(scores: Sequence[dict], by: str = "score") -> int:
    """Index of the best member under a :func:`selection_scores` key;
    ``by='rank'`` takes the Borda sum rank(score) + rank(consensus), the
    consensus breaking ties (it needs consensus in the scores)."""
    if by == "rank":
        if not scores or "consensus" not in scores[0]:
            raise ValueError("select_member(by='rank') needs consensus scores: call "
                             "selection_scores with anchor_params")

        def ranks(key):
            order = sorted(range(len(scores)), key=lambda i: scores[i][key])
            r = [0] * len(scores)
            for pos, i in enumerate(order):
                r[i] = pos
            return r

        rs, rc = ranks("score"), ranks("consensus")
        return int(min(range(len(scores)), key=lambda i: (rs[i] + rc[i], scores[i]["consensus"])))
    return int(min(range(len(scores)), key=lambda i: scores[i][by]))


# -- the schedule ----------------------------------------------------------------

def run_ensemble(trainer: Trainer, seeds: Sequence[int], rhos: Optional[Sequence[float]] = None,
                 epochs: Optional[int] = None, stacked: Optional[TrainState] = None,
                 mesh=None) -> tuple:
    """Train the members ``seeds`` (each with its rho of ``rhos``) through
    the trainer's whole schedule, the hybrid Adam -> L-BFGS switch included:
    member 0 logs through the trainer's logger, member i >= 1 as
    ``<name>_m<i>``; snapshots and the checkpoints ``<name>_e{epoch}_m{i}``
    and ``<name>_final_m{i}`` per member; ``train.stop_tol`` stops once every
    member's |loss| is under it. Returns (stacked state, one summary a
    member, with its ``epochs``, ``member`` and ``seed``)."""
    if mesh is not None:
        raise NotImplementedError(f"members sharded over a device mesh: {SLICE_6}")
    exp = trainer.exp
    n = len(seeds)
    width = max(exp.model.layers[1:-1], default=0)
    if n > 1 and width >= 100:
        print(f"run_ensemble: trunk width {width}: K8 batches the members of nets up to "
              f"32 wide only; these {n} run one after another on the card (the wide K3 or "
              f"the generic step), so expect ~{n}x the solo wall clock", flush=True)
    pin_numerics()
    if stacked is None:
        stacked = init_ensemble_states(trainer, seeds, rhos=rhos)
    elif len(stacked.key) != n:
        raise ValueError(f"the stacked state has {len(stacked.key)} members, seeds {n}")

    out_dir = exp.train.out_dir or None
    loggers = [trainer.logger] + [
        MetricsLogger(out_dir=out_dir, name=f"{exp.name}_m{i}", console=False)
        for i in range(1, n)]
    total = exp.train.epochs if epochs is None else epochs
    chunk = max(1, min(exp.train.chunk, total))
    lbfgs_chunk = max(1, min(chunk // 100 or 1, 10))
    crossed = Trainer._crossed
    runs = {}
    epoch = int(stacked.epoch)
    t0 = time.time()
    while epoch < total:
        phase = trainer._phase(epoch)
        length = min(chunk if phase == "adam" else lbfgs_chunk, total - epoch)
        if phase == "adam" and exp.optimizer.kind == "hybrid":
            length = min(length, exp.optimizer.switch_epoch - epoch)
        if (phase, length) not in runs:
            runs[(phase, length)] = make_ensemble_chunk(trainer, length, phase)
        stacked, metrics = runs[(phase, length)](stacked)
        epoch += length
        if exp.train.stop_tol > 0.0:
            last = metrics["loss"][-1].cpu().numpy()
            if np.all(np.abs(last) <= exp.train.stop_tol):
                total = epoch  # the final log below, then the loop ends
        if epoch >= total or crossed(epoch, length, exp.train.log_every):
            # one device -> host copy of every member's last row
            values = torch.stack([metrics[k][-1] for k in METRIC_KEYS]).cpu().numpy()
            elapsed = time.time() - t0
            t0 = time.time()
            for i in range(n):
                loggers[i].log(epoch=epoch, phase=phase, member=i, elapsed=elapsed,
                               **{k: float(values[j, i]) for j, k in enumerate(METRIC_KEYS)})
        want_snap = out_dir and crossed(epoch, length, exp.train.snapshot_every)
        want_ckpt = out_dir and crossed(epoch, length, exp.train.checkpoint_every)
        if want_snap or want_ckpt:
            for i, member in enumerate(unstack_states(stacked, n)):
                if want_snap:
                    _member_snapshot(trainer, loggers[i], member, epoch)
                if want_ckpt:
                    trainer.save_checkpoint(member, tag=f"e{epoch}_m{i}")

    summaries = [dict(s, epochs=epoch) for s in evaluate_ensemble(trainer, stacked, n)]
    for i, (logger, summary) in enumerate(zip(loggers, summaries)):
        logger.write_summary(dict(summary, member=i, seed=int(seeds[i])))
    if out_dir:
        for i, member in enumerate(unstack_states(stacked, n)):
            trainer.save_checkpoint(member, tag=f"final_m{i}")
    return stacked, summaries


def _member_snapshot(trainer: Trainer, logger: MetricsLogger, state: TrainState, epoch: int):
    """A full-grid prediction snapshot of one member, in the solo run's CSV schema."""
    ds = trainer.problem.dataset
    preds = trainer.predict(state.params, ds.X_star)
    cols = {"x": ds.X_star[:, 0], "t": ds.X_star[:, 1]}
    for name in ds.field_names:
        cols[f"{name}_pred"] = preds[name][:, 0]
    cols["epoch"] = np.full(ds.X_star.shape[0], epoch)
    logger.append_snapshot(cols)
