"""ADMM splitting of the L1 residual penalty (port of
``pinns_tpu/losses/admm.py``, whose docstring cites the reference).

z and the scaled dual are per-collocation-point vectors, initialized
z = r(w_0) and dual = 1. The weight step minimizes
(rho/2) ||r(w) - z + dual/rho||^2 (plus dual^T r with ``explicit_inner``);
then z = soft_threshold(r + dual/rho, 1/(rho N_f)) and dual += rho (r - z).
The Burgers slice has one residual; the tuple-of-residuals form of the Euler
system comes with slice 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pinns_tpu_torch.ops.prox import soft_threshold


class ADMMState(NamedTuple):
    """Auxiliary and scaled-dual variables, each (N_f, 1)."""

    z: torch.Tensor
    dual: torch.Tensor


def _single(residuals):
    if isinstance(residuals, tuple):
        raise NotImplementedError(
            "multi-residual ADMM (the Euler system) is ported with slice 2"
        )
    return residuals


def admm_init(residuals: torch.Tensor) -> ADMMState:
    """z = r(w_0), dual = ones."""
    f = _single(residuals).detach()
    return ADMMState(z=f.clone(), dual=torch.ones_like(f))


def admm_penalty(
    residuals: torch.Tensor, state: ADMMState, rho: float, explicit_inner: bool = False
):
    """(rho/2)||r - z + dual/rho||^2, plus dual^T r when ``explicit_inner``."""
    f = _single(residuals)
    q = f - state.z + state.dual / rho
    val = 0.5 * rho * torch.sum(q * q)
    if explicit_inner:
        val = val + torch.sum(state.dual * f)
    return val


def admm_update(residuals: torch.Tensor, state: ADMMState, rho: float, n_f: int) -> ADMMState:
    """One (z, dual) update at the given residual values: z first from the old
    dual, then dual from the new z; threshold 1/(rho * n_f)."""
    f = _single(residuals)
    c = 1.0 / (rho * n_f)
    z_new = soft_threshold(f + state.dual / rho, c)
    return ADMMState(z=z_new, dual=state.dual + rho * (f - z_new))


def admm_misfit(residuals: torch.Tensor, state: ADMMState):
    """Consistency monitor mean|r(w) - z|."""
    return torch.mean(torch.abs(_single(residuals) - state.z))
