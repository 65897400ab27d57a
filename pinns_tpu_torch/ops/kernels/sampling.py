"""Wrapper of K11, the generic step's collocation draw (``csrc/sampling.cu``),
and its plain version.

K11 replaces no TPU kernel (JAX draws with threefry inside its scanned step,
``pinns_tpu/train/trainer.py:360``): it is the port's Philox draw,
``data.sampling.philox_uniform`` bit for bit, as one launch that reads its
epoch and seed words and its (lb, ub) from row ``cursor`` of the epoch
schedule (``train.schedule``). So the per-epoch step and the graphed chunk
(``ops.kernels.generic_chunk``), which replays one captured launch over a
chunk's rows, draw the same points. The header of ``csrc/sampling.cu`` has
what bounds it (its launch) and the design.

:func:`philox_draw` launches the kernel on CUDA tensors and runs the plain
version, :func:`philox_draw_reference` (``philox_uniform`` at the row's
values), on CPU tensors; it raises on anything else and never falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pinns_tpu_torch.data.sampling import philox_uniform
from pinns_tpu_torch.device import raw_stream
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.train import schedule

LAUNCHES = 0  # K11 launches in this process (chip_smoke.py reads it)
_launches_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.float64: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library("sampling")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pinns_philox_draw.argtypes = [p, p, i, i, i, i, i, i, p, i, p]
        lib.pinns_philox_draw.restype = i
        lib.pinns_sampling_error_string.argtypes = [i]
        lib.pinns_sampling_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(sched: torch.Tensor, cursor: torch.Tensor, n: int, dtype) -> None:
    if sched.dtype != torch.int32 or sched.dim() != 2 or sched.shape[1] != schedule.ROW_WORDS \
            or not sched.is_contiguous():
        raise ValueError(f"K11 takes a contiguous (L, {schedule.ROW_WORDS}) int32 schedule, got "
                         f"{sched.dtype} {tuple(sched.shape)}")
    if cursor.dtype != torch.int64 or cursor.numel() != 1 or cursor.device != sched.device:
        raise ValueError(f"K11 takes a one-element int64 cursor on the schedule's device, got "
                         f"{cursor.dtype} {tuple(cursor.shape)} on {cursor.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"K11 draws float32 or float64 points, not {dtype}")
    if n < 0:
        raise ValueError(f"K11: {n} points")


def philox_draw(sched: torch.Tensor, cursor: torch.Tensor, n: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, 2) points of ``dtype``: Philox(seed, epoch) uniform in [lb, ub)
    with the seed, the epoch and the bounds of row ``cursor`` of ``sched``
    ((L, ROW_WORDS) int32; ``cursor`` a one-element int64 tensor), as
    ``data.sampling.philox_uniform`` draws them. One launch of K11 on a CUDA
    schedule (nothing read back to the host), the plain version on a CPU
    one."""
    global LAUNCHES
    _check(sched, cursor, n, dtype)
    if sched.device.type == "cpu":
        return philox_draw_reference(sched, cursor, n, dtype)
    if sched.device.type != "cuda":
        raise ValueError(f"K11 runs on a CUDA device, got {sched.device}")
    index = sched.get_device()
    out = torch.empty((n, 2), dtype=dtype, device=sched.device)
    lib = _LIB or _lib()
    err = lib.pinns_philox_draw(
        sched.data_ptr(), cursor.data_ptr(), schedule.ROW_WORDS, schedule.EPOCH_WORD,
        schedule.SEED_WORD, schedule.VALUE_WORD, n, _DTYPES[dtype], out.data_ptr(), index,
        raw_stream(index))
    if err != 0:
        msg = lib.pinns_sampling_error_string(err).decode()
        raise RuntimeError(f"K11 (philox_draw) launch failed: CUDA error {err} ({msg}); n {n}")
    with _launches_lock:
        LAUNCHES += 1
    return out


def philox_draw_reference(sched: torch.Tensor, cursor: torch.Tensor, n: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of :func:`philox_draw`: ``philox_uniform`` at the
    seed, epoch and bounds that row ``cursor`` of ``sched`` holds, on the
    schedule's device (it reads the row on the host)."""
    row = schedule.row_fields(sched[int(cursor.reshape(-1)[0])].cpu().numpy())[0]
    epoch = int(row["epoch"][0]) | (int(row["epoch"][1]) << 32)
    seed = int(row["seed"][0]) | (int(row["seed"][1]) << 32)
    return philox_uniform(seed, epoch, n, [float(v) for v in row["lb"]],
                          [float(v) for v in row["ub"]], dtype, sched.device)
