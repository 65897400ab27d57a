"""Data-misfit and residual-penalty terms with the reference's normalizations
(port of ``pinns_tpu/losses/misfit.py``, whose docstring cites the reference
script of each kind).

data misfit kinds:   'mse_sum'  (1/N_u) ||u - u_hat||_2^2
                     'l2_norm'  ||u - u_hat||_2 (unsquared)
residual kinds:      'mean_sq'     mean(f^2)
                     'l2_sq_norm'  (1/N_f) ||f||_2^2
                     'l1_sq_norm'  (1/N_f) ||f||_1^2

The causal-in-time penalty is ported with slice 2 (Euler and the weak form).
"""

from __future__ import annotations

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


def causal_residual_penalty(*args, **kwargs):
    raise NotImplementedError(
        "the causal-in-time residual penalty is ported with slice 2 (Euler and "
        "the weak form)"
    )
