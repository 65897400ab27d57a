"""Nested forward-mode (jvp) derivative operators (port of
``pinns_tpu/ops/derivatives.py`` on ``torch.func.jvp``).

The generic formulation of the derivatives that ``ops.taylor`` computes in
closed form for tanh MLPs: they take ANY apply function of (N, 2) points
(x, t), so a custom architecture gets its residual streams, and they are the
cross-check of the Taylor-mode path in the tests.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp


def _unit_tangent(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Tangent dX with ones in input column ``dim``, zeros elsewhere."""
    e = torch.zeros((1, x.shape[-1]), dtype=x.dtype, device=x.device)
    e[0, dim] = 1.0
    return e.expand(x.shape)


def derivs_1_jvp(
    apply_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, dy/dx0, dy/dx1) by two jvp sweeps. x: (N, 2)."""
    y, y_x = jvp(apply_fn, (x,), (_unit_tangent(x, 0),))
    _, y_t = jvp(apply_fn, (x,), (_unit_tangent(x, 1),))
    return y, y_x, y_t


def derivs_2_jvp(
    apply_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, dy/dx0, dy/dx1, d2y/dx0^2) by a jvp of a jvp. x: (N, 2)."""
    ex = _unit_tangent(x, 0)

    def dfdx(z):
        return jvp(apply_fn, (z,), (ex[:1].expand(z.shape),))[1]

    y, y_t = jvp(apply_fn, (x,), (_unit_tangent(x, 1),))
    y_x, y_xx = jvp(dfdx, (x,), (ex,))
    return y, y_x, y_t, y_xx
