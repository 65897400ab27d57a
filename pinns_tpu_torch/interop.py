"""The port's way in from a JAX run: parameter conversion and the params file.

JAX keeps an MLP as a list of ``{"W": (din, dout), "b": (1, dout)}`` arrays
(``pinns_tpu.models.mlp.init_mlp``); the port keeps the same layout in torch,
so conversion is a copy in each direction.

The params file (``.npz``) holds
  ``layers`` (int64), ``lb``/``ub`` (float64, as the spec holds them),
  ``W{i}``/``b{i}`` per layer, ``lambda1``/``lambda2`` (the Burgers
  coefficients), and optionally ``experiment`` (a name string).
Other keys are ignored on load, so a file may carry extra arrays beside them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params


def params_from_jax(
    layers: Sequence[Dict[str, np.ndarray]], device: torch.device
) -> Params:
    """JAX params (a list of ``{"W","b"}`` numpy arrays) -> float32 port
    params on ``device``."""
    out = []
    for i, layer in enumerate(layers):
        w = np.asarray(layer["W"])
        b = np.asarray(layer["b"]).reshape(1, -1)
        if w.ndim != 2 or b.shape[1] != w.shape[1]:
            raise ValueError(f"layer {i}: W {w.shape} and b {b.shape} do not match")
        out.append(
            {
                "W": torch.as_tensor(w, dtype=torch.float32).to(device).contiguous(),
                "b": torch.as_tensor(b, dtype=torch.float32).to(device).contiguous(),
            }
        )
    return out


def params_to_numpy(params: Params) -> List[Dict[str, np.ndarray]]:
    """Port params -> the JAX pytree layout as numpy arrays."""
    return [
        {k: layer[k].detach().cpu().numpy() for k in ("W", "b")} for layer in params
    ]


def save_params_npz(
    path: str,
    spec: MLPSpec,
    params,
    lambda1: float,
    lambda2: float,
    experiment: Optional[str] = None,
    **extra: np.ndarray,
) -> str:
    """Write ``params`` (port tensors or JAX-layout numpy) with the spec's
    widths and bounds and the Burgers coefficients; ``extra`` arrays ride
    along under their own names."""
    if params and isinstance(params[0]["W"], torch.Tensor):
        params = params_to_numpy(params)
    if len(params) != len(spec.layers) - 1:
        raise ValueError(
            f"{len(params)} layers of params for spec widths {spec.layers}"
        )
    arrays = {
        "layers": np.asarray(spec.layers, np.int64),
        "lb": np.asarray(spec.lb, np.float64),
        "ub": np.asarray(spec.ub, np.float64),
        "lambda1": np.asarray(lambda1, np.float32).reshape(()),
        "lambda2": np.asarray(lambda2, np.float32).reshape(()),
    }
    for i, layer in enumerate(params):
        arrays[f"W{i}"] = np.asarray(layer["W"], np.float32)
        arrays[f"b{i}"] = np.asarray(layer["b"], np.float32).reshape(1, -1)
    if experiment is not None:
        arrays["experiment"] = np.asarray(experiment)
    np.savez(path, **arrays, **extra)
    return path


def load_params_npz(path: str) -> dict:
    """Read a params file: ``{"spec", "params" (numpy, JAX layout),
    "lambda1", "lambda2", "experiment"}``."""
    with np.load(path, allow_pickle=False) as z:
        layers = tuple(int(w) for w in z["layers"])
        spec = MLPSpec(layers=layers, lb=tuple(z["lb"]), ub=tuple(z["ub"]))
        params = [
            {"W": z[f"W{i}"], "b": z[f"b{i}"]} for i in range(len(layers) - 1)
        ]
        for i, (din, dout) in enumerate(zip(layers[:-1], layers[1:])):
            if params[i]["W"].shape != (din, dout) or params[i]["b"].shape != (1, dout):
                raise ValueError(
                    f"{path}: layer {i} has W {params[i]['W'].shape}, "
                    f"b {params[i]['b'].shape}; widths say ({din}, {dout})"
                )
        return {
            "spec": spec,
            "params": params,
            "lambda1": float(z["lambda1"]),
            "lambda2": float(z["lambda2"]),
            "experiment": str(z["experiment"]) if "experiment" in z else None,
        }
