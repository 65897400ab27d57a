"""Wrapper of K8s (c), the member reduction of a served ensemble
(``csrc/ensemble.cu``), and its plain PyTorch version.

It replaces the XLA reduction of JAX's ensemble prediction over the stacked
members (``pinns_tpu/parallel/ensemble.py:340-358``, ``pinns_tpu/serve.py:
126-143``): per (point, channel) the members' mean, their population
standard deviation (ddof 0, two passes, as ``jnp.std``) and, for the
x-derivatives, |mean|. One thread a (point, channel) sums the members in
index order in float32; the header of ``csrc/ensemble.cu`` has what bounds it
(bytes). The plain version is :func:`member_stats_reference` (``torch.mean``
and ``torch.std(correction=0)`` over dim 0).

The wrapper validates what the kernel assumes and raises otherwise; it never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from pinns_tpu_torch.ops.kernels import build

LAUNCHES = 0  # K8s (c) launches in this process (chip_smoke.py reads it)
_launches_lock = threading.Lock()  # HTTP handler threads launch concurrently


def _lib():
    lib = build.load_library("ensemble")
    if not getattr(lib, "_pinns_typed", False):
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pinns_member_stats.argtypes = [p, p, i, q, q, p, p, p, i, p]
        lib.pinns_member_stats.restype = i
        lib.pinns_ensemble_error_string.argtypes = [i]
        lib.pinns_ensemble_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def _check(name: str, t: torch.Tensor, device, members: Optional[int] = None) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"member_stats kernel needs CUDA tensors on one device, got {name} on "
                         f"{t.device}")
    if t.dtype != torch.float32 or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"member_stats kernel takes a contiguous float32 (E, N, C) {name}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if members is not None and t.shape[0] != members:
        raise ValueError(f"member_stats: {name} has {t.shape[0]} members, the fields {members}")


def member_stats(values: torch.Tensor, dx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(mean, std, |mean dx|) over the member axis from one launch of K8s
    (c): ``values`` the (E, N, C) float32 stack of the members' fields,
    ``dx`` None or the (E, N, Cd) stack of their x-derivatives, contiguous on
    one CUDA device. mean and std are (N, C), the third (N, Cd) or None."""
    global LAUNCHES
    _check("values", values, values.device)
    e, n, c = values.shape
    if dx is not None:
        _check("dx", dx, values.device, e)
        if dx.shape[1] != n:
            raise ValueError(f"member_stats: dx has {dx.shape[1]} points, the fields {n}")
    mean = torch.empty((n, c), dtype=torch.float32, device=values.device)
    std = torch.empty_like(mean)
    dxabs = None if dx is None else torch.empty(dx.shape[1:], dtype=torch.float32,
                                                device=values.device)
    lib = _lib()
    err = lib.pinns_member_stats(
        values.data_ptr(), None if dx is None else dx.data_ptr(), e, n * c,
        0 if dx is None else n * dx.shape[2], mean.data_ptr(), std.data_ptr(),
        None if dxabs is None else dxabs.data_ptr(), values.device.index or 0,
        torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        msg = lib.pinns_ensemble_error_string(err).decode()
        raise RuntimeError(f"member_stats kernel launch failed: CUDA error {err} ({msg}); "
                           f"values {tuple(values.shape)}")
    with _launches_lock:
        LAUNCHES += 1
    return mean, std, dxabs


def member_stats_reference(values: torch.Tensor, dx: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of :func:`member_stats`, on any device and dtype."""
    mean = torch.mean(values, dim=0)
    std = torch.std(values, dim=0, correction=0)
    return mean, std, None if dx is None else torch.abs(torch.mean(dx, dim=0))
