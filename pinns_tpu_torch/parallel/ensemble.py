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

A chunk of the ensemble (:func:`make_ensemble_chunk`) is
- on the card, for Adam epochs inside K3's scope at the narrow widths
  (``abgrall_admm``, ``burgers_admm_batch``): K8, the member-batched fused
  Adam epoch (``ops.kernels.fused_step``), its epochs replayed from captured
  CUDA graphs (K9, one runner a member count, kept on the trainer);
- otherwise the member loop: each member's solo step in turn (the wide K3,
  the generic step over the kernels, the weak form, L-BFGS; the plain step
  on the CPU), each with its own seed and rho. JAX's vmapped L-BFGS leaves a
  converged member as it is, so each member's trajectory is its solo one.
Either way member i equals the solo run of its seed and rho bit for bit.

:func:`run_ensemble` runs the trainer's whole schedule (the hybrid switch
included) with per-member logs, snapshots, checkpoints and summaries; with
a mesh (slice 6, ``parallel.mesh``) each ensemble coordinate runs its share
of the members on its card (and data-parallel over its row of ranks when
the mesh's data axis is above 1), and the summaries are gathered to rank 0;
:func:`selection_scores` and :func:`select_member` pick a member without
ground truth.

Serving an ensemble: :func:`ensemble_predict` (per field the members' mean,
std and, with ``want_dx``, the |mean d/dx| front feature, over
:func:`ensemble_stats`: on the card K8s (a), the member-batched K1, or solo
K7a calls into one buffer, then K8s (c), the member reduction),
:func:`uq_calibration` and its numpy cores :func:`calibration_stats` and
:func:`mond_band_factors` (split-conformal and Mondrian band factors, copies
of JAX's, line for line). ``serve.export_ensemble`` writes the artifact.
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
from pinns_tpu_torch.train.trainer import METRIC_KEYS, Trainer, TrainState, swa_params, swa_update

# the JAX package's own refusal (pinns_tpu/parallel/ensemble.py:75-80)
RAD_REFUSAL = ("sampling.strategy='rad' re-draws the batch at chunk boundaries via "
               "Trainer.train and is not wired into the vmapped ensemble loop — use solo "
               "runs (or the sweep runner's serial path) for RAD")


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


def stack_params(trees) -> dict:
    """Member params-shaped trees ({'net', ...}: params or Adam moments)
    stacked as a stacked state holds them: the nets as views of one (E,
    n_params) buffer, the rest by torch.stack."""
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
        params=stack_params([s.params for s in states]),
        opt_state=AdamState(count=s0.opt_state.count,
                            mu=stack_params([s.opt_state.mu for s in states]),
                            nu=stack_params([s.opt_state.nu for s in states])),
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
    """Whether an Adam epoch of this trainer's ensembles is one K8 epoch: on
    the card, inside K3's scope, at the narrow design's widths."""
    from pinns_tpu_torch.ops.kernels.fused_step import design, fused_step_supported

    problem = trainer.problem
    return (problem.device.type == "cuda" and not fused_step_supported(problem.exp, problem.spec)
            and design(problem.spec.layers) == "narrow" and problem.shard is None)


def k8_chunk(trainer: Trainer, n: int):
    """K9 over K8 for ``n`` members (``ops.kernels.fused_step.FusedChunk``),
    made at first use and kept on the trainer with its captured graphs."""
    from pinns_tpu_torch.ops.kernels.fused_step import FusedChunk

    key = ("k8", n)
    if key not in trainer._chunks:
        trainer._chunks[key] = FusedChunk(trainer.problem, trainer.learning_rate, n_members=n)
    return trainer._chunks[key]


def make_ensemble_chunk(trainer: Trainer, chunk: int, phase: str = "adam"):
    """``run(stacked, new_colloc=None) -> (stacked, {metric: (chunk, E)})``:
    ``chunk`` epochs of every member, the metrics in one (chunk, E, 7) device
    buffer with no host sync inside the chunk (the L-BFGS solve syncs in its
    line search, as a solo one does). ``phase`` is 'adam' or 'lbfgs' (one
    whole inner solve an epoch). ``new_colloc`` (chunk, E, N_f, 2) replaces
    the Philox draws (the tests feed JAX's batches). K8's chunks replay its
    graphs (:func:`k8_chunk`); the member loop runs the rest."""
    if trainer.exp.sampling.strategy == "rad":
        raise ValueError(RAD_REFUSAL)
    if phase == "adam":
        step = trainer._adam_step
    elif phase == "lbfgs":
        step = trainer._lbfgs_step
    else:
        raise ValueError(f"unknown phase {phase!r}")
    from pinns_tpu_torch.ops.kernels.fused_step import fused_step_supported

    batched = phase == "adam" and batched_on_card(trainer)
    # K10's chunk runner, or K9's for the generic step (outside K3's scope),
    # member by member, as a solo run's chunks take it (so that a member
    # equals its solo run bit for bit); one graph serves every member's seed
    generic = bool(fused_step_supported(trainer.exp, trainer.problem.spec))
    solo_chunks = (getattr(step, "graphed", None) is not None
                   and (phase == "lbfgs" or generic))

    def run(stacked: TrainState, new_colloc: Optional[torch.Tensor] = None):
        n = len(stacked.key)
        if batched:
            return k8_chunk(trainer, n).run(stacked, chunk, new_colloc)
        buf = torch.empty((chunk, n, len(METRIC_KEYS)), dtype=torch.float32,
                          device=stacked.colloc.device)
        members = [_own(m) for m in unstack_states(stacked, n)]
        for i in range(n):
            if solo_chunks:
                members[i], m = trainer._get_chunk(phase)(
                    members[i], chunk, None if new_colloc is None else new_colloc[:, i])
                buf[:, i] = torch.stack([m[k] for k in METRIC_KEYS], dim=1)
                continue
            for t in range(chunk):
                members[i], _ = step(members[i], buf[t, i],
                                     None if new_colloc is None else new_colloc[t, i])
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


def n_members(stacked_params: dict) -> int:
    return int(net_leaves(stacked_params["net"])[0].shape[0])


def member_params(stacked_params: dict, i: int) -> dict:
    """Member ``i`` of a stacked params tree (views)."""
    return tree_map(lambda t: t[i], stacked_params)


def scores_at(trainer: Trainer, stacked: TrainState, pts: torch.Tensor, n: Optional[int] = None,
              anchor_params=None, coarse_scales: Sequence[float] = ()) -> List[dict]:
    """:func:`selection_scores` at the given points (N, 2): one dict a member
    with ``data_term``, ``resid_ms``, ``score``, for each coarse scale s
    ``coarse_r<s>`` and ``coarse_ent<s>`` and, with ``anchor_params`` (a
    stacked params tree), ``consensus``. Only ``stacked.params`` is read."""
    from pinns_tpu_torch.train.trainer import make_data_term

    problem = trainer.problem
    n = n_members(stacked.params) if n is None else n
    members = [member_params(stacked.params, i) for i in range(n)]
    dterm = make_data_term(problem)
    w = float(problem.exp.loss.data_weight)
    d, ms = [], []
    with torch.no_grad():
        for params in members:
            d.append(dterm(params).to(torch.float32))
            res = problem.training_residuals(params, pts)
            res = res if isinstance(res, tuple) else (res,)
            ms.append(sum(torch.mean(torch.square(f.to(torch.float32))) for f in res) / len(res))
        d = torch.stack([t.reshape(()) for t in d]).cpu().numpy()
        ms = torch.stack([t.reshape(()) for t in ms]).cpu().numpy()
        coarse = {}
        for s in coarse_scales:
            # the weak-form cells at s times the configured half-widths, and
            # their entropy violation, whatever residual the members trained
            rows = [problem.flux_residuals_and_entropy(params, pts, True, scale=float(s))
                    for params in members]
            coarse[f"coarse_r{s:g}"] = torch.stack([
                sum(torch.mean(torch.abs(f.to(torch.float32))) for f in leaves) / len(leaves)
                for leaves in (r if isinstance(r, tuple) else (r,) for r, _ in rows)
            ]).cpu().numpy()
            coarse[f"coarse_ent{s:g}"] = torch.stack(
                [torch.mean(ent.to(torch.float32)) for _, ent in rows]).cpu().numpy()
        consensus = None
        if anchor_params is not None:
            anchor = [_primaries(problem, member_params(anchor_params, i), pts)
                      for i in range(n_members(anchor_params))]
            mean = {k: torch.mean(torch.stack([a[k] for a in anchor]), dim=0)
                    for k in anchor[0]}
            names = sorted(mean)
            norm = torch.linalg.vector_norm

            def dist(params):
                p = _primaries(problem, params, pts)
                per = [norm(p[k] - mean[k]) / (norm(mean[k]) + 1e-12) for k in names]
                return sum(per) / len(per)

            consensus = torch.stack([dist(params) for params in members]).cpu().numpy()
    return [
        {"member": i, "data_term": float(d[i]), "resid_ms": float(ms[i]),
         "score": float(w * d[i] + ms[i]), **{k: float(v[i]) for k, v in sorted(coarse.items())},
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
    ensemble's mean prediction) when ``anchor_params`` is given. With
    ``coarse_scales`` each scale s adds the coarse-cell battery:
    ``coarse_r<s>`` (the mean |r| of the weak-form cells at s times the
    configured half-widths, averaged over the equations) and
    ``coarse_ent<s>`` (their mean entropy violation). The draw is the port's
    own: JAX's threefry points differ."""
    from pinns_tpu_torch.data.sampling import uniform_box

    problem = trainer.problem
    pts = uniform_box(torch.Generator().manual_seed(int(seed)), n_points, problem.lb,
                      problem.ub, problem.spec.dtype, problem.device)
    return scores_at(trainer, stacked, pts, n, anchor_params, coarse_scales)


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


# -- prediction and calibration (serving an ensemble) ----------------------------

def pack_members(nets: Sequence) -> torch.Tensor:
    """The member nets' :func:`pack_params` as the rows of one contiguous
    (E, S) float32 buffer, S the parameter count rounded up to a multiple of
    4 (so that K8s (a) keeps the tiled design's 16-byte weight copies)."""
    rows = [pack_params(net) for net in nets]
    p = rows[0].numel()
    flat = torch.zeros((len(rows), -(-p // 4) * 4), dtype=rows[0].dtype, device=rows[0].device)
    for m, row in enumerate(rows):
        flat[m, :p] = row
    return flat


def member_outputs(spec, pde: str, flat: torch.Tensor, x: torch.Tensor, lambda1=None,
                   lambda2=None, gamma: float = 1.4, want_dx: bool = False):
    """The members' network fields and residuals at x (N, 2), stacked:
    (names, values (E, N, C) in the order of ``names``, dx (E, N, Cd) in the
    order of ``train.evaluate.DX_FIELDS[pde]`` or None). ``flat`` (E, S)
    holds the members' nets (:func:`pack_members`); ``lambda1``/``lambda2``
    are the Burgers coefficients, broadcastable to (E, 1, 1).

    On a CUDA tensor: Burgers' four Taylor-2 streams of every member from
    one launch of K8s (a), the member-batched K1, and the combine f = u_t +
    lambda1 u u_x - lambda2 u_xx once on the (E, N, 1) streams; the Euler
    members and every member's dx from solo K7a calls, each reading its row
    of ``flat`` and writing its slices of one preallocated (E, N, .) buffer
    (for Euler, dx is the x stream of those same calls). On the CPU the plain
    versions."""
    from pinns_tpu_torch.ops import taylor
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.residuals import euler_combine

    e, n = flat.shape[0], x.shape[0]
    on_card = x.device.type == "cuda"
    nets = k_taylor2.nets_from_flat(spec, flat)

    def taylor1_streams():
        bufs = tuple(torch.empty((e, n, spec.out_dim), dtype=flat.dtype, device=x.device)
                     for _ in range(3))
        for m, net in enumerate(nets):
            if on_card:
                k_taylor1.taylor1(spec, net, x, out=tuple(b[m] for b in bufs), flat=flat[m])
            else:
                for b, t in zip(bufs, taylor.mlp_taylor_1_reference(spec, net, x)):
                    b[m].copy_(t)
        return bufs

    if pde == "euler":
        y, y_x, y_t = taylor1_streams()
        _, fs = euler_combine(*(t.view(e * n, 3) for t in (y, y_x, y_t)), gamma)
        values = torch.cat([y] + [f.view(e, n, 1) for f in fs], dim=2)
        return ("rho", "u", "E", "f1", "f2", "f3"), values, y_x if want_dx else None
    if pde != "burgers":
        raise ValueError(f"unknown pde {pde!r}")
    members = k_taylor2.taylor2_members if on_card else k_taylor2.taylor2_members_reference
    u, u_x, u_t, u_xx = members(spec, flat, x)
    f = u_t + lambda1 * u * u_x - lambda2 * u_xx
    return ("u", "f"), torch.cat([u, f], dim=2), taylor1_streams()[1] if want_dx else None


def ensemble_stats(spec, pde: str, flat: torch.Tensor, x: torch.Tensor, lambda1=None,
                   lambda2=None, gamma: float = 1.4, want_dx: bool = False) -> dict:
    """``{field: {'mean': (N, 1), 'std': (N, 1), 'members': (E, N, 1)}}`` of
    the members' fields and residuals at x (:func:`member_outputs`), with
    ``'dx'`` = |mean of the members' d(field)/dx| on the network fields under
    ``want_dx``, as tensors on x's device. The statistics come from one launch
    of K8s (c), the member reduction, on a CUDA tensor (its plain version on
    the CPU): the mean in float32 and the population std (ddof 0) by a second
    pass over the deviations, as JAX's ``jnp.mean`` / ``jnp.std``."""
    from pinns_tpu_torch.ops.kernels import ensemble as k_ensemble
    from pinns_tpu_torch.train.evaluate import DX_FIELDS

    names, values, dx = member_outputs(spec, pde, flat, x, lambda1, lambda2, gamma, want_dx)
    on_card = x.device.type == "cuda"
    reduce = k_ensemble.member_stats if on_card else k_ensemble.member_stats_reference
    mean, std, dx_abs = reduce(values.to(torch.float32), None if dx is None else
                               dx.to(torch.float32))
    out = {name: {"mean": mean[:, j:j + 1], "std": std[:, j:j + 1],
                  "members": values[:, :, j:j + 1]} for j, name in enumerate(names)}
    if dx is not None:
        for j, name in enumerate(DX_FIELDS[pde]):
            out[name]["dx"] = dx_abs[:, j:j + 1]
    return out


def ensemble_predict(trainer: Trainer, stacked: TrainState, x, want_dx: bool = False) -> dict:
    """Deep-ensemble prediction, as JAX's ``ensemble_predict``: ``{field:
    {'mean': (N, 1), 'std': (N, 1), 'members': (E, N, 1)}}`` as numpy, and
    with ``want_dx`` ``'dx'`` = |mean of the members' d(field)/dx| on the
    network fields (the serving-time front feature of the Mondrian bands).
    Each member's Burgers coefficients are its own (``effective_coeffs``).
    Only ``stacked.params`` is read (:func:`ensemble_stats` has the kernels)."""
    problem = trainer.problem
    spec = problem.spec
    e = n_members(stacked.params)
    members = [member_params(stacked.params, i) for i in range(e)]
    pin_numerics()
    with torch.no_grad():
        coeffs = [problem.effective_coeffs(p) for p in members]
        lam1, lam2 = (torch.stack([c[k].reshape(()) for c in coeffs]).view(e, 1, 1)
                      for k in (0, 1))
        xt = torch.as_tensor(np.asarray(x), dtype=spec.dtype).to(problem.device).contiguous()
        stats = ensemble_stats(spec, problem.exp.pde.kind,
                               pack_members([p["net"] for p in members]), xt, lam1, lam2,
                               problem.exp.pde.gamma, want_dx)
    return {name: {k: v.cpu().numpy() for k, v in row.items()} for name, row in stats.items()}


def calibration_stats(exact, mean, std, grad_mag=None, ks=(1.0, 2.0, 3.0), alpha=0.05,
                      n_cal=1024, seed=0, n_bins=4, bin_feature=None,
                      feature_name="std") -> dict:
    """Coverage and conformal band factors of an ensemble's ``mean`` +- k
    ``std`` against ``exact`` (numpy, line for line JAX's
    ``calibration_stats``): raw coverage at k std for each k, the shock
    decile of ``grad_mag`` (``cov2s_shock``), the leaky whole-grid factor
    ``k95``, split-conformal ``k_conf95`` from a held-out random subset of
    ``n_cal`` points (``default_rng(seed)``) with ``cov_conf95`` verified on
    the rest, and the Mondrian factors: points binned by ``bin_feature``
    (default the predicted std; ``feature_name`` is recorded as
    ``mond_feature``) over ``mond_edges`` fit on one half of the calibration
    subset, one conformal quantile ``mond_k`` a bin from the other half (the
    global factor for a bin of fewer than 20), ``cov_mond95`` and
    ``cov_mond95_shock`` on the rest."""
    exact = np.asarray(exact, np.float64)
    mean = np.asarray(mean, np.float64)
    std = np.asarray(std, np.float64)
    err = np.abs(mean - exact)
    row = {f"cov{k:g}s": float(np.mean(err <= k * std + 1e-12)) for k in ks}
    shock_mask = None
    if grad_mag is not None:
        gm = np.asarray(grad_mag, np.float64).ravel()
        shock_mask = gm >= np.quantile(gm, 0.9)
        row["cov2s_shock"] = float(
            np.mean(err.ravel()[shock_mask] <= 2.0 * std.ravel()[shock_mask] + 1e-12))
    row["mean_std"] = float(np.mean(std))
    row["rmse"] = float(np.sqrt(np.mean(err**2)))
    scores = err.ravel() / (std.ravel() + 1e-12)
    row["k95"] = float(np.quantile(scores, 1.0 - alpha))
    n = scores.size
    m = int(min(n_cal, n // 4)) or 1
    idx = np.random.default_rng(seed).permutation(n)
    cal, rest = idx[:m], idx[m:]
    level = min(1.0, np.ceil((m + 1) * (1.0 - alpha)) / m)
    k_conf = float(np.quantile(scores[cal], level, method="higher"))
    row["k_conf95"] = k_conf
    band_ok = err.ravel() <= k_conf * std.ravel() + 1e-12
    row["cov_conf95"] = float(np.mean(band_ok[rest]))
    rest_shock = None
    if shock_mask is not None:
        rest_shock = np.zeros(n, bool)
        rest_shock[rest] = True
        rest_shock &= shock_mask
        if rest_shock.any():
            row["cov_conf95_shock"] = float(np.mean(band_ok[rest_shock]))
    if n_bins > 1 and m >= 2:
        s_all = (np.asarray(bin_feature, np.float64).ravel()
                 if bin_feature is not None else std.ravel())
        row["mond_feature"] = feature_name
        cal_edges, cal_scores = cal[: m // 2], cal[m // 2:]
        edges = np.quantile(s_all[cal_edges], np.linspace(0.0, 1.0, n_bins + 1)[1:-1])
        bin_of = np.searchsorted(edges, s_all, side="right")
        mond_k = []
        for b in range(n_bins):
            sel = cal_scores[bin_of[cal_scores] == b]
            if sel.size >= 20:
                lvl = min(1.0, np.ceil((sel.size + 1) * (1.0 - alpha)) / sel.size)
                mond_k.append(float(np.quantile(scores[sel], lvl, method="higher")))
            else:
                mond_k.append(k_conf)
        k_pt = np.asarray(mond_k)[bin_of]
        mond_ok = err.ravel() <= k_pt * std.ravel() + 1e-12
        row["mond_edges"] = [float(e) for e in edges]
        row["mond_k"] = mond_k
        row["cov_mond95"] = float(np.mean(mond_ok[rest]))
        if rest_shock is not None and rest_shock.any():
            row["cov_mond95_shock"] = float(np.mean(mond_ok[rest_shock]))
    return row


def mond_band_factors(cal_row: dict, std, default: float = 2.0, feature=None) -> np.ndarray:
    """Per-point band factors from one :func:`calibration_stats` row, as JAX's
    ``mond_band_factors``: each point's Mondrian factor, binned by its own
    value of the row's ``mond_feature`` over ``mond_edges`` (``std``, or the
    predicted |d/dx| passed as ``feature`` for a 'dx' row), else a constant
    array of ``k_conf95`` (or ``default``). A 'dx' row without a feature, or
    a row without bins, takes the constant."""
    edges, mond_k = cal_row.get("mond_edges"), cal_row.get("mond_k")
    std = np.asarray(std, np.float64)
    if not edges or not mond_k:
        return np.full(std.shape, float(cal_row.get("k_conf95", default)))
    needs_dx = cal_row.get("mond_feature", "std") == "dx"
    if needs_dx and feature is None:
        return np.full(std.shape, float(cal_row.get("k_conf95", default)))
    feat = np.asarray(feature, np.float64) if needs_dx else std
    idx = np.searchsorted(np.asarray(edges, np.float64), feat, side="right")
    return np.asarray(mond_k, np.float64)[idx]


def uq_calibration(trainer: Trainer, stacked: TrainState, ks=(1.0, 2.0, 3.0), n_bins: int = 4,
                   mond_feature: str = "std") -> dict:
    """Coverage calibration of the ensemble on the dataset's dense grid, as
    JAX's ``uq_calibration``: :func:`ensemble_predict` at ``X_star`` (with
    the dx feature when ``mond_feature`` is 'dx'), the shock decile from the
    |x-gradient| of the exact (Nt, Nx) field (``np.gradient`` along x), then
    :func:`calibration_stats` per primary field: ``{field: row}``."""
    if mond_feature not in ("std", "dx"):
        raise ValueError(f"unknown mond_feature {mond_feature!r} (expected 'std' or 'dx')")
    ds = trainer.problem.dataset
    preds = ensemble_predict(trainer, stacked, ds.X_star, want_dx=mond_feature == "dx")
    out = {}
    for name, p in preds.items():
        if name not in ds.star:  # the residuals have no exact field
            continue
        gx = np.abs(np.gradient(np.asarray(ds.fields[name], np.float64), axis=1))
        grad_mag = np.broadcast_to(gx.reshape(-1, 1), np.asarray(p["mean"]).shape)
        out[name] = calibration_stats(
            ds.star[name], p["mean"], p["std"], grad_mag=grad_mag, ks=ks, n_bins=n_bins,
            bin_feature=p.get("dx") if mond_feature == "dx" else None,
            feature_name=mond_feature)
    return out


# -- the schedule ----------------------------------------------------------------

def mesh_members(n: int, mesh) -> List[int]:
    """The members of an n-member ensemble that this rank's ensemble
    coordinate trains (contiguous blocks, in order): all of them without a
    mesh."""
    if mesh is None:
        return list(range(n))
    return [int(i) for i in np.array_split(np.arange(n), mesh.ensemble)[mesh.coords[0]]]


def run_ensemble(trainer: Trainer, seeds: Sequence[int], rhos: Optional[Sequence[float]] = None,
                 epochs: Optional[int] = None, stacked: Optional[TrainState] = None,
                 mesh=None) -> tuple:
    """Train the members ``seeds`` (each with its rho of ``rhos``) through
    the trainer's whole schedule, the hybrid Adam -> L-BFGS switch included:
    member 0 logs through the trainer's logger, member i >= 1 as
    ``<name>_m<i>``; snapshots and the checkpoints ``<name>_e{epoch}_m{i}``
    and ``<name>_final_m{i}`` per member; ``train.stop_tol`` stops once every
    member's |loss| is under it. Returns (stacked state, one summary a
    member, with its ``epochs``, ``member`` and ``seed``). With
    ``train.swa_frac`` each member keeps its own SWA mean over the stacked
    params (JAX's ``:602-679``): the summaries' ``swa_snapshots`` and
    ``swa_*`` entries and the checkpoints ``<name>_swa_m{i}``.

    With ``mesh`` (``parallel.mesh.make_mesh``; every rank calls it) the
    ensemble coordinate e trains members ``mesh_members(n, mesh)`` on its
    card, the K8 epoch or the member loop as without a mesh; with a data
    axis above 1 the trainer is sharded over the coordinate's row
    (``parallel.sharding.shard_trainer``) and the members run the solo
    data-parallel chunk in turn. Each member's logs and checkpoints keep
    its global index and are written by its owner (data rank 0 of its row).
    ``stacked``, when given, holds this coordinate's members (whole rows).
    The training issues no collective when the data axis is 1. Returns
    (this coordinate's stacked state, every member's summary in member
    order on rank 0, this coordinate's elsewhere): the summaries are
    gathered to rank 0 by one object gather."""
    full_seeds = list(seeds)
    ids = mesh_members(len(full_seeds), mesh)
    if mesh is not None:
        from pinns_tpu_torch.parallel.sharding import place_ensemble, shard_trainer

        if mesh.coords is None:
            raise ValueError(f"rank {mesh.rank} is outside the {mesh.ensemble}x{mesh.data} mesh")
        if mesh.data > 1 and trainer.problem.shard is None:
            shard_trainer(trainer, mesh)
        seeds = [full_seeds[i] for i in ids]
        rhos = None if rhos is None else [rhos[i] for i in ids]
        if stacked is not None and mesh.data > 1:
            stacked = place_ensemble(stacked, mesh)
    # a coordinate past the last member trains nothing (it joins the gather)
    summaries = _run_members(trainer, seeds, ids, rhos, epochs, stacked) if ids else (None, [])
    if mesh is None:
        return summaries
    return summaries[0], _gather_summaries(summaries[1], ids, mesh)


def _gather_summaries(local: List[dict], ids: List[int], mesh) -> List[dict]:
    """Every member's summary, in member order, on rank 0 (an object gather
    over the process group, counted as 'gather_object'); this
    coordinate's elsewhere. Only data rank 0 of a row evaluated."""
    import torch.distributed as dist

    from pinns_tpu_torch.parallel import sharding

    mine = list(zip(ids, local)) if mesh.coords[1] == 0 else []
    if not (dist.is_available() and dist.is_initialized()):
        return [s for _, s in sorted(mine)]
    sharding.count("gather_object")
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, parts, dst=0)
    if dist.get_rank() != 0:
        return local
    return [s for _, s in sorted(pair for part in parts for pair in part)]


def _run_members(trainer: Trainer, seeds: Sequence[int], ids: Sequence[int],
                 rhos: Optional[Sequence[float]], epochs: Optional[int],
                 stacked: Optional[TrainState]) -> tuple:
    """:func:`run_ensemble` for the members ``ids`` (global indices, for
    the logs and checkpoints) of ``seeds`` (theirs)."""
    exp = trainer.exp
    n = len(seeds)
    shard = trainer.problem.shard
    owner = shard is None or shard.owner
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

    out_dir = (exp.train.out_dir or None) if owner else None
    loggers = [trainer.logger if i == 0 else
               MetricsLogger(out_dir=out_dir, name=f"{exp.name}_m{i}",
                             console=owner and i == ids[0])
               for i in ids]
    total = exp.train.epochs if epochs is None else epochs
    chunk = max(1, min(exp.train.chunk, total))
    lbfgs_chunk = max(1, min(chunk // 100 or 1, 10))
    crossed = Trainer._crossed
    runs = {}
    swa_start = (total - int(round(exp.train.swa_frac * total))
                 if exp.train.swa_frac > 0.0 else None)
    swa_avg, swa_n = None, 0
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
        if swa_start is not None and epoch > swa_start:
            swa_avg, swa_n = swa_update(swa_avg, swa_n, stacked.params)
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
        want_ckpt = exp.train.out_dir and crossed(epoch, length, exp.train.checkpoint_every)
        if want_snap or want_ckpt:
            for i, member in enumerate(unstack_states(stacked, n)):
                if want_snap:
                    _member_snapshot(trainer, loggers[i], member, epoch)
                if want_ckpt:  # a collective under a shard: every rank of the row
                    trainer.save_checkpoint(member, tag=f"e{epoch}_m{ids[i]}")

    # data rank 0 evaluates (the params are replicated over its row)
    summaries = ([dict(s, epochs=epoch) for s in evaluate_ensemble(trainer, stacked, n)]
                 if owner else [{"epochs": epoch} for _ in range(n)])
    if swa_n > 0:
        swa_stacked = stacked._replace(params=swa_params(swa_avg, stacked.params))
        for i, member in enumerate(unstack_states(swa_stacked, n)):
            summaries[i]["swa_snapshots"] = swa_n
            if owner:
                for k, v in trainer.evaluate(member).items():
                    summaries[i][f"swa_{k}"] = v
            if exp.train.out_dir:
                trainer.save_checkpoint(member, tag=f"swa_m{ids[i]}")
    for i, (logger, summary) in enumerate(zip(loggers, summaries)):
        logger.write_summary(dict(summary, member=ids[i], seed=int(seeds[i])))
    if exp.train.out_dir:
        for i, member in enumerate(unstack_states(stacked, n)):
            trainer.save_checkpoint(member, tag=f"final_m{ids[i]}")
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
