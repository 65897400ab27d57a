"""Collocation data parallelism of the training step (port of
``pinns_tpu/parallel/sharding.py``).

Every loss term of a PINN is a reduction over pointwise terms, so the
collocation batch, and the ADMM (z, dual) vectors indexed by it, split
along the mesh's data axis, while the params, the optimizer state and the
(small) supervised set stay replicated. JAX gets the split from GSPMD; the
port spells it out:

- a rank holds rows ``[row0, row0 + n_f / D)`` of the batch the one-card run
  would hold, drawn at that row offset (Philox's counter is the row), so
  the union of the ranks' batches is the one-card batch bit for bit;
- each rank forms its share of the loss (the data term on data rank 0
  alone, every mean over the global row count) and its gradient, and one
  flat all-reduce sums the gradients and the loss metrics; a term that is
  not linear in a sum over points (``l1_sq_norm``'s S^2 / n) all-reduces
  its sum first;
- every rank then takes the same Adam step (or the same L-BFGS decision) on
  identical inputs, so the params stay replicated without a broadcast.

:class:`DataShard` is a rank's part of that (``Problem.shard``);
:func:`shard_trainer` installs it, :func:`place_state` puts a state into the
layout (its rows of the batch and the ADMM state, the rest broadcast from
data rank 0) and :func:`gather_state` takes it back whole, for a checkpoint.
JAX's ``collective_census`` reads the compiled HLO; the port counts its own
collectives by kind in :data:`COLLECTIVES` (host calls, and those inside a
replayed graph), which the tests read in its place.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional

import torch

from pinns_tpu_torch.parallel.mesh import Mesh

COLLECTIVES: Dict[str, int] = {}  # the port's collectives by kind, in this process
_lock = threading.Lock()


def count(kind: str, n: int = 1) -> None:
    with _lock:
        COLLECTIVES[kind] = COLLECTIVES.get(kind, 0) + n


def collective_counts() -> Dict[str, int]:
    with _lock:
        return {k: v for k, v in COLLECTIVES.items() if v}


def reset_collectives() -> None:
    with _lock:
        COLLECTIVES.clear()


@dataclasses.dataclass(frozen=True)
class DataShard:
    """One rank's part of a data-parallel model: data coordinate ``rank`` of
    ``size`` in the process group ``group`` (None: a one-rank shard with no
    process group, which issues no collective). ``owner`` (data rank 0)
    counts the data term and writes the logs and checkpoints."""

    rank: int
    size: int
    group: Any = None

    @property
    def owner(self) -> bool:
        return self.rank == 0

    def rows(self, total: int) -> slice:
        """This rank's rows of a batch of ``total`` rows."""
        if total % self.size:
            raise ValueError(f"{total} collocation rows are not divisible by the mesh 'data' "
                             f"axis size {self.size}")
        n = total // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data row, in place; returns it."""
        if self.group is not None:
            import torch.distributed as dist

            count("all_reduce")
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of data rank 0 on every rank of the row, in place."""
        if self.group is not None:
            import torch.distributed as dist

            count("broadcast")
            dist.broadcast(t, group=self.group, group_src=0)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' row blocks of ``t`` stacked in rank order: the whole."""
        if self.group is None:
            return t
        import torch.distributed as dist

        count("all_gather")
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


class _GlobalValueAndGrad(torch.autograd.Function):
    """f(x) = the sum over the data row of ``share(x)``, with its gradient
    formed by one flat all-reduce of [the local gradient, the local share]
    in the forward; the backward returns the saved global gradient."""

    @staticmethod
    def forward(ctx, x, share, shard):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            f = share(xx)
            (g,) = torch.autograd.grad(f, xx)
        flat = shard.all_reduce(torch.cat([g.reshape(-1), f.detach().reshape(1).to(g.dtype)]))
        ctx.save_for_backward(flat[:-1])
        return flat[-1].reshape(())

    @staticmethod
    def backward(ctx, go):
        (g,) = ctx.saved_tensors
        return go * g, None, None


def global_objective(share, shard: DataShard):
    """The L-BFGS objective under data parallelism (the host loop and
    ``AutogradLBFGS``; ``DeviceLBFGS`` splits K3's value-and-grad instead):
    ``x -> f(x)``, the data
    row's sum of ``share`` (each rank's share of the loss), differentiable,
    its gradient the row's sum of the shares' gradients, from one flat
    all-reduce an evaluation. Every rank gets the same value and gradient,
    so every rank's solver takes the same decisions."""
    return lambda x: _GlobalValueAndGrad.apply(x, share, shard)


def dp_later(exp) -> list:
    """What ``exp`` uses that this port does not run under data parallelism
    yet (each names its later slice, ROADMAP queue 2); empty when it runs."""
    later = []
    if exp.loss.causal_eps > 0.0:
        later.append("the causal penalty's time-bin weights over the whole batch "
                     "(loss.causal_eps) under data parallelism: slice 6b")
    if exp.sampling.strategy == "rad":
        later.append("RAD's residual-importance draw over the whole pool "
                     "(sampling.strategy='rad') under data parallelism: slice 6b")
    return later


def shard_trainer(trainer, mesh: Mesh):
    """Configure ``trainer`` for data-parallel training on ``mesh``: checks
    that the data axis divides ``sampling.n_f`` (JAX's ``ValueError``),
    installs this rank's :class:`DataShard` on the problem, rebuilds the
    steps and clears the chunk runners, so that every later epoch runs on
    this rank's rows. Ranks other than data rank 0 log nothing. Returns
    the trainer."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.train.metrics import MetricsLogger
    from pinns_tpu_torch.train.trainer import check_slice, make_lbfgs_step, make_step

    n_f = trainer.exp.sampling.n_f
    if n_f % mesh.data:
        raise ValueError(f"sampling.n_f={n_f} must be divisible by the mesh 'data' axis "
                         f"size {mesh.data}")
    if mesh.data > 1:  # the refusals of check_slice at this data axis
        check_slice(override(trainer.exp, {"mesh.data_parallel": mesh.data}))
    problem = trainer.problem
    problem.shard = mesh_shard(mesh)
    trainer._adam_step = make_step(problem, trainer.learning_rate)
    trainer._lbfgs_step = make_lbfgs_step(problem)
    trainer._chunks.clear()
    if not problem.shard.owner:
        trainer.logger.close()
        trainer.logger = MetricsLogger(out_dir=None, name=trainer.exp.name, console=False)
    return trainer


def mesh_shard(mesh: Mesh) -> DataShard:
    """This rank's :class:`DataShard` of ``mesh``'s data row."""
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.ensemble}x{mesh.data} mesh")
    return DataShard(rank=mesh.coords[1], size=mesh.data, group=mesh.data_group)


def place_state(state, mesh: Mesh):
    """A whole ``state`` (a one-card run's, or a checkpoint's) in the
    data-parallel layout, as JAX's ``place_state`` after ``load_checkpoint``:
    this rank's rows of the batch and of the ADMM z and dual, the params and
    Adam's moments broadcast from data rank 0 (JAX's ``device_put`` to the
    replicated sharding). The key, the epoch, Adam's count and rho must
    agree between ranks and are not sent. (A trainer with a shard draws
    its own rows at init: its ``init_state`` needs no placing.)"""
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.opt.adam import AdamState, tree_map

    shard = mesh_shard(mesh)
    cut = shard.rows(state.colloc.shape[0])
    rows = lambda t: t[cut].clone()  # noqa: E731
    bcast = lambda t: shard.broadcast(t.detach().clone())  # noqa: E731
    opt = state.opt_state
    admm = state.admm
    if admm is not None:
        admm = ADMMState(z=tree_map(rows, admm.z), dual=tree_map(rows, admm.dual))
    return state._replace(
        params=tree_map(bcast, state.params),
        opt_state=AdamState(count=opt.count, mu=tree_map(bcast, opt.mu),
                            nu=tree_map(bcast, opt.nu)),
        admm=admm, colloc=rows(state.colloc))


def gather_state(state, shard: Optional[DataShard]):
    """The whole state of a data-parallel run on every rank of the row: the
    batch and the ADMM z and dual gathered in rank order (the rest is
    replicated). What a checkpoint holds; :func:`place_state` cuts it
    again."""
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.opt.adam import tree_map

    if shard is None or shard.group is None:
        return state
    admm = state.admm
    if admm is not None:
        admm = ADMMState(z=tree_map(shard.all_gather_rows, admm.z),
                         dual=tree_map(shard.all_gather_rows, admm.dual))
    return state._replace(admm=admm, colloc=shard.all_gather_rows(state.colloc))


def place_ensemble(stacked_state, mesh: Mesh):
    """A stacked ensemble state in the mesh's layout: with ``data > 1``
    each member's batch and ADMM state in this rank's rows (the member
    axis leads); along the ensemble axis each coordinate keeps the members
    ``parallel.ensemble.run_ensemble`` gives it."""
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.opt.adam import tree_map

    if mesh.data <= 1:
        return stacked_state
    cut = mesh_shard(mesh).rows(stacked_state.colloc.shape[1])
    rows = lambda t: t[:, cut].clone()  # noqa: E731
    admm = stacked_state.admm
    if admm is not None:
        admm = ADMMState(z=tree_map(rows, admm.z), dual=tree_map(rows, admm.dual))
    return stacked_state._replace(colloc=rows(stacked_state.colloc), admm=admm)
