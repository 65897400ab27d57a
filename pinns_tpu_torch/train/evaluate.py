"""Prediction and the metric of record (port of ``pinns_tpu/train/evaluate.py``).

``relative_l2`` is ||exact - pred||_2 / ||exact||_2. ``predict_fields`` takes
a ``Problem`` and the params tree {'net', 'coeffs'}, as in JAX, and evaluates
the network fields and PDE residuals in one pass under the problem's spec, so
a run with a mixed stream policy is evaluated through that policy, as JAX's
is: on a CUDA device through the fused Taylor-2 kernel (K1, or K6 for a
mixed spec). ``burgers_fields`` is the same pass for callers that
hold a bare network and coefficients (the served model).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params


def relative_l2(pred, exact) -> float:
    """||exact - pred||_2 / ||exact||_2 over flattened arrays."""
    pred = np.asarray(pred).ravel()
    exact = np.asarray(exact).ravel()
    return float(np.linalg.norm(exact - pred) / np.linalg.norm(exact))


def burgers_fields(
    spec: MLPSpec, net: Params, x: torch.Tensor, lambda1, lambda2
) -> Dict[str, torch.Tensor]:
    """{'u', 'f'}, each (N, 1), of a Burgers network at points x (N, 2)."""
    from pinns_tpu_torch.ops.residuals import burgers_residual

    u, f = burgers_residual(spec, net, x, lambda1, lambda2)
    return {"u": u, "f": f}


def predict_fields(problem, params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Network fields and PDE residuals at points x (N, 2): {'u', 'f'} for
    Burgers. Euler ({'rho','u','E','f1','f2','f3'}) comes with slice 2."""
    if problem.exp.pde.kind != "burgers":
        raise NotImplementedError(
            f"pde {problem.exp.pde.kind!r}: the Euler prediction path is ported "
            "with slice 2"
        )
    lam1, lam2 = problem.effective_coeffs(params)
    return burgers_fields(problem.spec, params["net"], x, lam1, lam2)
