"""Prediction and the metric of record (port of ``pinns_tpu/train/evaluate.py``).

``relative_l2`` is ||exact - pred||_2 / ||exact||_2. ``predict_fields`` takes
a ``Problem`` and the params tree {'net', 'coeffs'}, as in JAX, and evaluates
the network fields and PDE residuals in one pass under the problem's spec, so
a run with a mixed stream policy is evaluated through that policy, as JAX's
is: on a CUDA device through the fused Taylor kernels (K1, or K6 for a mixed
spec, for Burgers; K7a for Euler). ``burgers_fields`` and ``euler_fields``
are the same passes for callers that hold a bare network (the served model).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params

# the network's outputs per PDE, in output order: the fields whose
# x-derivative is the front feature of a 'dx' calibration
DX_FIELDS = {"burgers": ("u",), "euler": ("rho", "u", "E")}


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


def euler_fields(spec: MLPSpec, net: Params, x: torch.Tensor,
                 gamma: float = 1.4) -> Dict[str, torch.Tensor]:
    """{'rho', 'u', 'E', 'f1', 'f2', 'f3'}, each (N, 1), of an Euler network
    at points x (N, 2)."""
    from pinns_tpu_torch.ops.residuals import euler_residuals

    (rho, u, e), (f1, f2, f3) = euler_residuals(spec, net, x, gamma)
    return {"rho": rho, "u": u, "E": e, "f1": f1, "f2": f2, "f3": f3}


def predict_fields(problem, params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Network fields and PDE residuals at points x (N, 2): {'u', 'f'} for
    Burgers, {'rho', 'u', 'E', 'f1', 'f2', 'f3'} for Euler."""
    exp = problem.exp
    if exp.pde.kind == "euler":
        return euler_fields(problem.spec, params["net"], x, exp.pde.gamma)
    if exp.pde.kind != "burgers":
        raise ValueError(f"unknown pde kind {exp.pde.kind!r}")
    lam1, lam2 = problem.effective_coeffs(params)
    return burgers_fields(problem.spec, params["net"], x, lam1, lam2)


def predict_field_dx(problem, params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The x-derivative of each network field at points x (N, 2) from one
    Taylor-1 pass (K7a on a CUDA tensor), the serving-time front feature of
    the Mondrian bands (``parallel.ensemble.uq_calibration(mond_feature=
    'dx')``): {'u'} for Burgers, {'rho', 'u', 'E'} for Euler, each (N, 1)."""
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1

    _, y_x, _ = mlp_taylor_1(problem.spec, params["net"], x)
    return dict(zip(DX_FIELDS[problem.exp.pde.kind], y_x.split(1, dim=1)))
