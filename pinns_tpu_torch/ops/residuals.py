"""Burgers residual on the Taylor-2 streams (port of ``pinns_tpu/ops/residuals.py``).

    f = u_t + lambda1 * u * u_x - lambda2 * u_xx

The streams come from ``ops.taylor.mlp_taylor_2`` (the fused kernel on CUDA);
the combine stays plain torch, as XLA did it outside the TPU kernel. The
Euler residuals are ported with slice 2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params
from pinns_tpu_torch.ops.taylor import mlp_taylor_2


def burgers_residual(
    spec: MLPSpec, params: Params, x: torch.Tensor, lambda1, lambda2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, f), each (N, 1), at points x (N, 2) with columns (x, t).

    lambda1, lambda2: convection and viscosity, Python floats or tensors
    broadcastable to (N, 1) on x's device.
    """
    u, f, _, _ = burgers_residual_aux(spec, params, x, lambda1, lambda2)
    return u, f


def burgers_residual_aux(
    spec: MLPSpec, params: Params, x: torch.Tensor, lambda1, lambda2
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Burgers residual plus the first derivatives it is built from:
    (u, f, u_x, u_t)."""
    u, u_x, u_t, u_xx = mlp_taylor_2(spec, params, x)
    f = u_t + lambda1 * u * u_x - lambda2 * u_xx
    return u, f, u_x, u_t
