"""PDE residuals on the Taylor streams (port of ``pinns_tpu/ops/residuals.py``).

Burgers, on the Taylor-2 streams (``ops.taylor.mlp_taylor_2``):

    f = u_t + lambda1 * u * u_x - lambda2 * u_xx

The 1D compressible Euler system, on the Taylor-1 streams of a 3-output net
(rho, u, E) (``ops.taylor.mlp_taylor_1``), with the gamma-law pressure
p = (gamma - 1)(E - rho u^2 / 2):

    f1 = rho_t + (rho u)_x
    f2 = (rho u)_t + (rho u^2 + p)_x
    f3 = E_t + (u (E + p))_x

The streams come from the fused kernels on CUDA (K1, K7a); the combine stays
plain torch, in the JAX package's float32 operation order, as XLA did it
outside the kernels. The shock-capture terms read the same streams:
:func:`euler_entropy_production`, the physical-entropy rate whose negative
part the entropy penalty squares.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pinns_tpu_torch.device import constant
from pinns_tpu_torch.models.mlp import MLPSpec, Params
from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_2


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


def euler_residuals(spec: MLPSpec, params: Params, x: torch.Tensor, gamma: float = 1.4):
    """((rho, u, E), (f1, f2, f3)), each entry (N, 1), at points x (N, 2) of
    a net with 3 outputs (rho, u, E) from one trunk."""
    fields, residuals, _ = euler_residuals_aux(spec, params, x, gamma)
    return fields, residuals


def euler_residuals_aux(spec: MLPSpec, params: Params, x: torch.Tensor, gamma: float = 1.4):
    """Euler residuals plus the first-derivative arrays they are built from:
    ((rho, u, E), (f1, f2, f3), (y_x, y_t)), y_* (N, 3) in field order."""
    y, y_x, y_t = mlp_taylor_1(spec, params, x)
    fields, residuals = euler_combine(y, y_x, y_t, gamma)
    return fields, residuals, (y_x, y_t)


def euler_combine(y, y_x, y_t, gamma: float = 1.4):
    """((rho, u, E), (f1, f2, f3)) from the Taylor-1 streams of the
    3-output net, each (N, 3) in field order."""
    rho, u, e = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    rho_x, u_x, e_x = y_x[:, 0:1], y_x[:, 1:2], y_x[:, 2:3]
    rho_t, u_t, e_t = y_t[:, 0:1], y_t[:, 1:2], y_t[:, 2:3]

    p = (gamma - 1.0) * (e - 0.5 * rho * u * u)
    p_x = (gamma - 1.0) * (e_x - 0.5 * (rho_x * u * u + 2.0 * rho * u * u_x))

    f1 = rho_t + (rho_x * u + rho * u_x)
    f2 = (rho_t * u + rho * u_t) + (rho_x * u * u + 2.0 * rho * u * u_x) + p_x
    f3 = e_t + (u_x * e + u * e_x) + (u_x * p + u * p_x)
    return (rho, u, e), (f1, f2, f3)


def euler_entropy_production(y, y_x, y_t, gamma: float = 1.4, eps: float = 1e-3):
    """D = S_t + u S_x for the specific entropy S = log p - gamma log rho,
    (N, 1), from the Taylor-1 streams (``pinns_tpu/ops/residuals.py:116``).
    Admissible weak solutions have D >= 0; the penalty squares relu(-D). p
    and rho are clamped at ``eps`` by ``torch.maximum``, whose gradient at a
    tie is half, as JAX's ``jnp.maximum``."""
    rho, u, e = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    rho_x, u_x, e_x = y_x[:, 0:1], y_x[:, 1:2], y_x[:, 2:3]
    rho_t, u_t, e_t = y_t[:, 0:1], y_t[:, 1:2], y_t[:, 2:3]
    g = gamma
    p = (g - 1.0) * (e - 0.5 * rho * u * u)
    p_x = (g - 1.0) * (e_x - 0.5 * (rho_x * u * u + 2.0 * rho * u * u_x))
    p_t = (g - 1.0) * (e_t - 0.5 * (rho_t * u * u + 2.0 * rho * u * u_t))
    floor = constant(eps, y.dtype, y.device)
    p_c = torch.maximum(p, floor)
    rho_c = torch.maximum(rho, floor)
    s_x = p_x / p_c - g * rho_x / rho_c
    s_t = p_t / p_c - g * rho_t / rho_c
    return s_t + u * s_x


def euler_pressure(rho, u, e, gamma: float = 1.4):
    """gamma-law pressure closure p = (gamma - 1)(E - rho u^2 / 2)."""
    return (gamma - 1.0) * (e - 0.5 * rho * u * u)
