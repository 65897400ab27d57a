"""Device selection and the port's numerics rule: full float32, no TF32, no
reduced-precision matmul on any backend.

The residual path needs full float32 accumulation (a 3-pass reduced-precision
matmul cost 4x rel-L2 on burgers_forward in the JAX package). PyTorch keeps
that choice in process-global switches: TF32 for cuBLAS and cuDNN, and the
float32 matmul precision, which also routes CPU matmuls through oneDNN in
bf16 when it is "medium". Any code in the same process can flip them, so
every entry point of the port pins them again (:func:`pin_numerics`) before
it computes, and :func:`resolve_device` pins them and checks that they read
back.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch


def pin_numerics() -> None:
    """Full float32 matmuls on every backend: TF32 off for cuBLAS and cuDNN,
    float32 matmul precision "highest" (also the oneDNN CPU matmul)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_numerics() -> None:
    """Raise if a global switch allows reduced-precision float32 matmuls.

    Reads the per-backend precisions (``fp32_precision``: 'ieee', or 'none'
    to inherit the global one), which both the legacy and the new precision
    API set; the legacy getter raises once the two APIs were mixed.
    """
    bad = []
    if torch.backends.cuda.matmul.allow_tf32:
        bad.append("torch.backends.cuda.matmul.allow_tf32")
    if torch.backends.cudnn.allow_tf32:
        bad.append("torch.backends.cudnn.allow_tf32")
    for name in ("backends", "backends.cuda.matmul", "backends.mkldnn.matmul",
                 "backends.mkldnn"):
        obj = torch
        for part in name.split("."):
            obj = getattr(obj, part, None)
        precision = getattr(obj, "fp32_precision", None)
        if precision not in (None, "ieee", "none"):
            bad.append(f"torch.{name}.fp32_precision={precision!r}")
    if bad:
        raise RuntimeError(f"reduced-precision float32 matmuls are on: {bad}")


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``name`` ("cpu", "cuda", "cuda:1", ...), with the
    numerics pinned and checked.

    Raises RuntimeError when CUDA is asked for and no card is visible: the
    port never moves to the CPU on its own.
    """
    pin_numerics()
    check_numerics()
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif device.type != "cpu":
        raise RuntimeError(f"unsupported device {str(device)!r}; use 'cpu' or 'cuda'")
    return device


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``, as
    the kernels' launchers take it: ``torch.cuda.current_stream(index).
    cuda_stream`` without building the Stream object, which costs a few
    microseconds a call on the host."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, shape: tuple, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


def constant(values, dtype: torch.dtype, device: Union[str, torch.device]) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, made once per
    (values, dtype, device) and shared by every caller: read it, never write
    it. An epoch captured in a CUDA graph may take it, where a copy from the
    host is illegal (the uncaptured warm-up epoch makes it first)."""
    arr = np.asarray(values, dtype=np.float64)
    return _constant(tuple(arr.reshape(-1).tolist()), arr.shape, dtype, torch.device(device))
