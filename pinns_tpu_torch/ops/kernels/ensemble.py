"""Wrapper of K8s (c), the member reduction of a served ensemble
(``csrc/ensemble.cu``), and its plain PyTorch version.

It replaces the XLA reduction of JAX's ensemble prediction over the stacked
members (``pinns_tpu/parallel/ensemble.py:340-358``, ``pinns_tpu/serve.py:
126-143``): per (point, channel) the members' mean, their population
standard deviation (ddof 0, two passes, as ``jnp.std``) and, for the
x-derivatives, |mean|, in one launch. A thread holds the members of up to four
(point, channel) entries in registers (one read of the stack up to 32
members) and sums them in index order in float32; the header of
``csrc/ensemble.cu`` has what bounds it (bytes) and the design. The plain
version is :func:`member_stats_reference` (``torch.mean`` and
``torch.std(correction=0)`` over dim 0).

The wrapper validates what the kernel assumes and raises otherwise; it never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from pinns_tpu_torch.device import raw_stream
from pinns_tpu_torch.ops.kernels import build

LAUNCHES = 0  # K8s (c) launches in this process (chip_smoke.py reads it)
_launches_lock = threading.Lock()  # HTTP handler threads launch concurrently


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library("ensemble")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pinns_member_stats.argtypes = [p, p, i, q, q, p, i, p]
        lib.pinns_member_stats.restype = i
        lib.pinns_ensemble_error_string.argtypes = [i]
        lib.pinns_ensemble_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _takes(t: torch.Tensor) -> bool:
    return t.dtype == torch.float32 and t.dim() == 3 and t.is_contiguous() and t.is_cuda


def _refuse(values: torch.Tensor, dx: Optional[torch.Tensor]) -> None:
    """Raise the ValueError that says why the kernel does not take these
    stacks."""
    stacks = (("values", values),) if dx is None else (("values", values), ("dx", dx))
    for name, t in stacks:
        if t.dtype != torch.float32 or t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"member_stats kernel takes a contiguous float32 (E, N, C) {name}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if dx is not None and dx.shape[:2] != values.shape[:2]:
        raise ValueError(f"member_stats: dx is (E, N) {tuple(dx.shape[:2])}, the fields "
                         f"{tuple(values.shape[:2])}")
    where = values.device if not values.is_cuda else dx.device
    raise ValueError(f"member_stats kernel needs CUDA tensors on one device, got {where}")


def member_stats(values: torch.Tensor, dx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(mean, std, |mean dx|) over the member axis from one launch of K8s
    (c): ``values`` the (E, N, C) float32 stack of the members' fields,
    ``dx`` None or the (E, N, Cd) stack of their x-derivatives, contiguous on
    one CUDA device. mean and std are (N, C), the third (N, Cd) or None:
    views of one output buffer. (Its host work before the launch is kept to
    a few checks, one allocation and the ctypes call; the views are made
    while the kernel runs.)"""
    global LAUNCHES
    if not _takes(values):
        _refuse(values, dx)
    e, n, c = values.shape
    index = values.get_device()
    cd = 0
    if dx is not None:
        if not (_takes(dx) and dx.get_device() == index and dx.shape[0] == e
                and dx.shape[1] == n):
            _refuse(values, dx)
        cd = dx.shape[2]
    out = values.new_empty(n * (2 * c + cd))
    lib = _LIB or _lib()
    err = lib.pinns_member_stats(
        values.data_ptr(), None if dx is None else dx.data_ptr(), e, n * c, n * cd,
        out.data_ptr(), index, raw_stream(index))
    if err != 0:
        msg = lib.pinns_ensemble_error_string(err).decode()
        raise RuntimeError(f"member_stats kernel launch failed: CUDA error {err} ({msg}); "
                           f"values {tuple(values.shape)}")
    with _launches_lock:
        LAUNCHES += 1
    mean = out.as_strided((n, c), (c, 1))
    std = out.as_strided((n, c), (c, 1), n * c)
    return mean, std, None if dx is None else out.as_strided((n, cd), (cd, 1), 2 * n * c)


def member_stats_reference(values: torch.Tensor, dx: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of :func:`member_stats`, on any device and dtype."""
    mean = torch.mean(values, dim=0)
    std = torch.std(values, dim=0, correction=0)
    return mean, std, None if dx is None else torch.abs(torch.mean(dx, dim=0))
