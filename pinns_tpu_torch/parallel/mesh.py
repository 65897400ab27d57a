"""The process mesh and the multi-GPU launch (port of
``pinns_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` with axes (ensemble,
data) and lets GSPMD insert the collectives. The port runs one process a
card, launched by ``python -m torch.distributed.run`` (torchrun), and lays
the ranks out on the same grid: :func:`make_mesh` gives each rank its
(ensemble, data) coordinates and a ``torch.distributed`` process group for
its data row (the ranks that share one model's collocation batch) and for
its ensemble column (the ranks that hold one data shard of different
members). The collectives run over NCCL on the card and over gloo for
``--device cpu``.

:func:`multihost_init` joins the process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
and gives each rank the card ``LOCAL_RANK``; a world of one needs no
launcher (torchrun's world of one still joins a group, whose
collectives are NCCL's one-rank ones).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Tuple

import torch

ENSEMBLE_AXIS = "ensemble"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (ensemble, data) grid of ranks: ``grid[e][d]`` is the global rank
    at ensemble coordinate e and data coordinate d. ``coords`` are this
    process's (None when the mesh leaves it out); ``data_group`` and
    ``ensemble_group`` the process groups of its row and column (None
    without a process group: a layout only)."""

    ensemble: int
    data: int
    grid: Tuple[Tuple[int, ...], ...]
    rank: int
    coords: Optional[Tuple[int, int]]
    data_group: Any = None
    ensemble_group: Any = None

    @property
    def shape(self) -> dict:
        return {ENSEMBLE_AXIS: self.ensemble, DATA_AXIS: self.data}

    @property
    def size(self) -> int:
        return self.ensemble * self.data


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data: int = 0, ensemble: int = 1, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh with axes (ensemble, data) over ``ranks`` (default: every rank
    of the process group). ``data=0`` means all remaining ranks. Raises
    ``ValueError`` as JAX's ``make_mesh`` does: for a rank count that
    ``ensemble`` does not divide (with ``data=0``) and for a mesh larger
    than the ranks. With a process group of more than one rank every rank
    must call it alike: it makes the groups of every row and column."""
    import torch.distributed as dist

    rank, size = world()
    ranks = list(range(size) if ranks is None else ranks)
    if data == 0:
        if len(ranks) % ensemble:
            raise ValueError(f"{len(ranks)} devices not divisible by ensemble={ensemble}")
        data = len(ranks) // ensemble
    n = data * ensemble
    if n > len(ranks):
        raise ValueError(f"mesh {ensemble}x{data} needs {n} devices, have {len(ranks)}")
    grid = tuple(tuple(ranks[e * data:(e + 1) * data]) for e in range(ensemble))
    coords = next(((e, d) for e, row in enumerate(grid) for d, r in enumerate(row) if r == rank),
                  None)
    data_group = ensemble_group = None
    if dist.is_available() and dist.is_initialized():
        # every rank creates every group, in one order (torch.distributed's rule)
        for e, row in enumerate(grid):
            g = dist.new_group(list(row))
            if coords is not None and coords[0] == e:
                data_group = g
        for d in range(data):
            g = dist.new_group([row[d] for row in grid])
            if coords is not None and coords[1] == d:
                ensemble_group = g
    return Mesh(ensemble=ensemble, data=data, grid=grid, rank=rank, coords=coords,
                data_group=data_group, ensemble_group=ensemble_group)


def multihost_init(device: str = "cuda") -> Tuple[int, int, str]:
    """Join torchrun's process group: NCCL when ``device`` is 'cuda' (each
    rank on the card ``LOCAL_RANK``), gloo for 'cpu'. Returns (rank, world
    size, this rank's device name). Without torchrun's ``WORLD_SIZE`` it
    joins nothing and returns (0, 1, ``device``).
    A rank that finds no card for its ``LOCAL_RANK`` raises."""
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return 0, 1, device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {os.environ.get('RANK')} has LOCAL_RANK {local} but "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA "
                "device(s) are visible: launch one process a card")
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    elif kind != "cpu":
        raise RuntimeError(f"unsupported device {device!r}; use 'cpu' or 'cuda'")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method="env://",
                                **({"device_id": torch.device(device)} if kind == "cuda" else {}))
    return dist.get_rank(), dist.get_world_size(), device
