"""The epoch schedule of the generic Adam step: a row an epoch of what the
host used to pass by value, so that an epoch reads it from the device.

An Adam epoch of the generic step (``train.trainer.make_adam_epoch``) takes
its per-epoch values from row ``cursor`` of a schedule table on the step's
device, never from Python scalars: the Philox draw's epoch and seed words
(K11, ``ops.kernels.sampling``), the time curriculum's (lb, ub)
(``trainer._curriculum_bounds``), Adam's learning rate (the
``opt.adam.learning_rate_schedule`` value at Adam's count) and its bias
corrections (``opt.adam.bias_corrections``). The per-epoch step writes one
row for its epoch; the graphed chunk (``ops.kernels.generic_chunk``) writes
a chunk's rows once and replays one captured epoch over them with a device
cursor. So both run one code path, and a captured epoch draws a new batch
under a new learning rate in every replay.

The values are computed here, on the host, in numpy, with the functions the
per-epoch step always used: a device ``cosf`` or ``powf`` need not give
numpy's bits. A row is :data:`ROW_WORDS` int32 words (72 bytes): the draw's
epoch and seed as (low, high) uint32 pairs, then seven float64 values
(lb0, lb1, ub0, ub1, lr, bc1, bc2) as they are on the host (a constant
rate's float, the curriculum's float32 bounds, the bias corrections' float32
values all exact in float64); the step rounds lr and the bias corrections to
its dtype on the device, as a Python scalar is rounded to a tensor's dtype.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from pinns_tpu_torch.opt.adam import bias_corrections

_ROW = np.dtype([("epoch", "<u4", (2,)), ("seed", "<u4", (2,)), ("lb", "<f8", (2,)),
                 ("ub", "<f8", (2,)), ("lr", "<f8"), ("bc", "<f8", (2,))])
ROW_WORDS = _ROW.itemsize // 4  # 18
EPOCH_WORD, SEED_WORD, VALUE_WORD = 0, 2, 4  # word offsets in a row
LB, UB, LR, BC1, BC2 = 0, 2, 4, 5, 6  # float64 offsets from VALUE_WORD
_MASK = 0xFFFFFFFF


def schedule_rows(key: int, count: int, epoch: int, length: int,
                  learning_rate: Union[float, Callable[[int], float]],
                  bounds: Callable[[int], Tuple]) -> np.ndarray:
    """The rows of ``length`` Adam epochs from a state at Adam's ``count``
    and ``epoch``: row i is the epoch that state.epoch + i steps, which draws
    Philox(``key``, epoch + 1 + i) inside ``bounds(epoch + i)`` (the
    curriculum's (lb, ub) for JAX's epoch argument) and steps at
    ``learning_rate(count + i)`` (or the float) with the bias corrections at
    count + i. (length, ROW_WORDS) int32."""
    rows = np.zeros(length, _ROW)
    e = np.arange(length, dtype=np.uint64) + np.uint64(epoch + 1)
    rows["epoch"][:, 0] = (e & np.uint64(_MASK)).astype(np.uint32)
    rows["epoch"][:, 1] = (e >> np.uint64(32)).astype(np.uint32)
    rows["seed"][:] = (key & _MASK, (key >> 32) & _MASK)
    for i in range(length):
        lb, ub = bounds(epoch + i)
        rows["lb"][i], rows["ub"][i] = lb, ub
        rows["bc"][i] = bias_corrections(count + i)
    # a schedule's rates in one call over the chunk's counts
    rows["lr"] = (learning_rate(np.arange(count, count + length)) if callable(learning_rate)
                  else learning_rate)
    return rows.view(np.int32).reshape(length, ROW_WORDS)


def row_fields(rows: np.ndarray) -> np.ndarray:
    """The structured view of (L, ROW_WORDS) int32 rows: fields 'epoch',
    'seed' (uint32 pairs), 'lb', 'ub', 'lr', 'bc' (float64)."""
    return np.ascontiguousarray(rows).view(_ROW).reshape(-1)


def row_at(sched: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """Row ``cursor`` of the table ``sched`` on its device, with no host
    read: its float64 values (:data:`LB` ...) as a (7,) view."""
    row = sched.index_select(0, cursor.reshape(1))[0]
    return row[VALUE_WORD:].view(torch.float64)


def to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Schedule rows on ``device``: through pinned memory without a host
    wait on a CUDA device (the caching host allocator keeps the page until
    the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
