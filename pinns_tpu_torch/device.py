"""Device selection and the port's numerics rule: float32 with TF32 off.

The residual path needs full float32 accumulation (a 3-pass reduced-precision
matmul cost 4x rel-L2 on burgers_forward in the JAX package), so every entry
point resolves its device through :func:`resolve_device`, which also switches
TF32 off for both cuBLAS matmuls and cuDNN.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``name`` ("cpu", "cuda", "cuda:1", ...).

    Raises RuntimeError when CUDA is asked for and no card is visible: the
    port never moves to the CPU on its own.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
