"""Data-misfit and residual-penalty terms with the reference's normalizations
(port of ``pinns_tpu/losses/misfit.py``, whose docstring cites the reference
script of each kind).

data misfit kinds:   'mse_sum'  (1/N_u) ||u - u_hat||_2^2
                     'l2_norm'  ||u - u_hat||_2 (unsquared)
residual kinds:      'mean_sq'     mean(f^2)
                     'l2_sq_norm'  (1/N_f) ||f||_2^2
                     'l1_sq_norm'  (1/N_f) ||f||_1^2

and the causal-in-time residual penalty of the weak-form recipes
(``causal_residual_penalty``).
"""

from __future__ import annotations

import numpy as np
import torch

DATA_MISFIT_KINDS = ("mse_sum", "l2_norm")
RESIDUAL_PENALTY_KINDS = ("mean_sq", "l2_sq_norm", "l1_sq_norm")


def data_misfit(pred: torch.Tensor, target: torch.Tensor, kind: str, n: int):
    """Data-fit term. ``n`` is the reference's N_u normalizer."""
    r = pred - target
    if kind == "mse_sum":
        return torch.sum(r * r) / n
    if kind == "l2_norm":
        return torch.sqrt(torch.sum(r * r))
    raise ValueError(f"unknown data misfit kind: {kind!r}")


def residual_penalty(f: torch.Tensor, kind: str, n: int):
    """Residual regularization term. ``n`` is the reference's N_f normalizer."""
    if kind == "mean_sq":
        return torch.mean(f * f)
    if kind == "l2_sq_norm":
        return torch.sum(f * f) / n
    if kind == "l1_sq_norm":
        s = torch.sum(torch.abs(f))
        return s * s / n
    raise ValueError(f"unknown residual penalty kind: {kind!r}")


def causal_residual_penalty(residuals, t: torch.Tensor, t_lb, t_ub, eps: float, bins: int,
                            relative: bool = False):
    """Causal-in-time mean-square residual (``pinns_tpu/losses/misfit.py:57``;
    Wang, Sankaran & Perdikaris 2022): with L_b the mean squared residual in
    time bin b (summed over the fields of a system), the term is

        (1/B) sum_b w_b L_b,   w_b = detach(exp(-eps * sum_{b' < b} L_b'))

    and with ``relative`` the prefix is divided by the detached mean bin loss
    (+1e-30) first. ``residuals`` is an (N, 1) tensor or a tuple of them;
    ``t`` the (N,) or (N, 1) times. Returns (term, weights (bins,)).

    The bin of a point is JAX's float32 (t - t_lb) / (t_ub - t_lb) * bins,
    truncated toward zero and clipped, so a point on a bin edge lands where
    JAX puts it. The per-bin sums are a one-hot product summed over the
    points by a plain reduction: deterministic on the card, where a
    scatter-add with float atomics would not be.
    """
    if not isinstance(residuals, tuple):
        residuals = (residuals,)
    sq = sum(torch.sum(f * f, dim=tuple(range(1, f.ndim))) for f in residuals)
    tt = t.reshape(-1)
    # the bound and the span in float32, as JAX computes them from the
    # grid's float32 bounds
    frac = (tt - float(np.float32(t_lb))) / float(np.float32(float(t_ub) - float(t_lb)))
    idx = torch.clamp((frac * bins).to(torch.int32), 0, bins - 1)
    onehot = (idx[:, None] == torch.arange(bins, device=tt.device, dtype=torch.int32)).to(sq.dtype)
    sums = torch.sum(onehot * sq[:, None], dim=0)
    counts = torch.sum(onehot, dim=0)
    l_b = sums / torch.clamp(counts, min=1.0)
    prefix = torch.cumsum(l_b, dim=0) - l_b  # exclusive: earlier bins only
    if relative:
        prefix = prefix / (torch.mean(l_b) + 1e-30)
    w = torch.exp(-eps * prefix).detach()
    return torch.mean(w * l_b), w
