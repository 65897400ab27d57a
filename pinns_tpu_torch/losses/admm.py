"""ADMM splitting of the L1 residual penalty (port of
``pinns_tpu/losses/admm.py``, whose docstring cites the reference).

z and the scaled dual are per-collocation-point vectors, initialized
z = r(w_0) and dual = 1. The weight step minimizes
(rho/2) ||r(w) - z + dual/rho||^2 (plus dual^T r with ``explicit_inner``);
then z = soft_threshold(r + dual/rho, 1/(rho N_f)) and dual += rho (r - z).
A system of PDEs (Euler: mass, momentum, energy) carries a tuple of
residuals; every function maps over its components, each with the same
threshold, and sums (the penalty) or averages (the misfit) the parts, as
``pinns_tpu/losses/admm.py`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from pinns_tpu_torch.ops.prox import soft_threshold

Residuals = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class ADMMState(NamedTuple):
    """Auxiliary and scaled-dual variables, each (N_f, 1); tuples of them for
    a system of PDEs."""

    z: Residuals
    dual: Residuals


def _map(fn, *trees):
    """fn over matching (tuples of) tensors."""
    if isinstance(trees[0], tuple):
        return tuple(fn(*xs) for xs in zip(*trees))
    return fn(*trees)


def admm_init(residuals: Residuals) -> ADMMState:
    """z = r(w_0), dual = ones."""
    return ADMMState(z=_map(lambda f: f.detach().clone(), residuals),
                     dual=_map(lambda f: torch.ones_like(f.detach()), residuals))


def admm_penalty(
    residuals: Residuals, state: ADMMState, rho: float, explicit_inner: bool = False
):
    """(rho/2)||r - z + dual/rho||^2, plus dual^T r when ``explicit_inner``,
    summed over the components."""

    def term(f, z, dual):
        q = f - z + dual / rho
        val = 0.5 * rho * torch.sum(q * q)
        if explicit_inner:
            val = val + torch.sum(dual * f)
        return val

    parts = _map(term, residuals, state.z, state.dual)
    return sum(parts) if isinstance(parts, tuple) else parts


def admm_update(residuals: Residuals, state: ADMMState, rho: float, n_f: int) -> ADMMState:
    """One (z, dual) update at the given residual values: z first from the old
    dual, then dual from the new z; threshold 1/(rho * n_f) for every
    component."""
    c = 1.0 / (rho * n_f)
    z_new = _map(lambda f, d: soft_threshold(f + d / rho, c), residuals, state.dual)
    dual_new = _map(lambda d, f, z: d + rho * (f - z), state.dual, residuals, z_new)
    return ADMMState(z=z_new, dual=dual_new)


def admm_misfit(residuals: Residuals, state: ADMMState):
    """Consistency monitor mean|r(w) - z|, averaged over the components."""
    parts = _map(lambda f, z: torch.mean(torch.abs(f - z)), residuals, state.z)
    return sum(parts) / len(parts) if isinstance(parts, tuple) else parts
