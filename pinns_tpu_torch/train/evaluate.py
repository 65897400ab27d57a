"""Prediction and the metric of record (port of ``pinns_tpu/train/evaluate.py``).

``relative_l2`` is ||exact - pred||_2 / ||exact||_2. ``predict_fields``
evaluates the network fields and PDE residuals in one pass. The JAX version
takes a ``Problem``; the port has no Problem yet, so it takes the spec, the
params and the PDE coefficients directly.
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


def predict_fields(
    spec: MLPSpec,
    params: Params,
    x: torch.Tensor,
    lambda1,
    lambda2,
    pde: str = "burgers",
) -> Dict[str, torch.Tensor]:
    """Network fields and PDE residuals at points x (N, 2): {'u', 'f'} for
    Burgers. Euler ({'rho','u','E','f1','f2','f3'}) comes with slice 2."""
    from pinns_tpu_torch.ops.residuals import burgers_residual

    if pde != "burgers":
        raise NotImplementedError(
            f"pde {pde!r}: the Euler prediction path is ported with slice 2"
        )
    u, f = burgers_residual(spec, params, x, lambda1, lambda2)
    return {"u": u, "f": f}
