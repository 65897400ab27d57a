"""Taylor-mode derivative streams through the tanh MLP (port of
``pinns_tpu/ops/taylor.py::mlp_taylor_2``).

One forward pass carries (value, d/dx, d/dt, d2/dx2) layer by layer:

  P = H  @ W + b          Px = Hx @ W        Pt = Ht @ W        Pxx = Hxx @ W
  s = tanh(P)             s' = 1 - s^2       s'' = -2 s s'
  H = s                   Hx = s' Px         Ht = s' Pt         Hxx = s'' Px^2 + s' Pxx

``mlp_taylor_2`` dispatches on the device of ``x``: a CPU tensor runs the
plain PyTorch recurrence (``mlp_taylor_2_reference``), a CUDA tensor runs the
fused kernel K1, differentiable in the params through its backward kernel K2
(``ops.kernels.taylor2``); each either launches or raises.

The mixed-precision stream policy (``compute_dtype``, ``keep_streams``) of
the JAX package is ported with slice 3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params, embed_streams, normalize_inputs
from pinns_tpu_torch.ops.kernels.taylor2 import mlp_taylor2_kernel

Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(spec: MLPSpec) -> None:
    if spec.in_dim != 2:
        raise ValueError("mlp_taylor_2 expects in_dim == 2 (x, t)")
    if spec.compute_dtype is not None or spec.keep_streams or spec.mixed_elementwise:
        raise NotImplementedError(
            "the mixed-precision stream policy (compute_dtype / keep_streams / "
            "mixed_elementwise) is ported with slice 3 (scale)"
        )


def mlp_taylor_2_reference(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams:
    """(y, y_x, y_t, y_xx), each (N, out_dim): the plain PyTorch recurrence,
    in ``spec.dtype`` on ``x``'s device (float32 matmuls, TF32 off)."""
    _check(spec)
    # hxx is None (identically zero) for the affine embedding
    h, hx, ht, hxx = embed_streams(spec, normalize_inputs(spec, x))
    for layer in params[:-1]:
        w, b = layer["W"], layer["b"]
        p = h @ w + b
        px = hx @ w
        pt = ht @ w
        s = torch.tanh(p)
        sp = 1.0 - s * s
        spp = -2.0 * s * sp
        hxx = spp * px * px if hxx is None else spp * px * px + sp * (hxx @ w)
        h = s
        hx = sp * px
        ht = sp * pt
    w, b = params[-1]["W"], params[-1]["b"]
    return h @ w + b, hx @ w, ht @ w, hxx @ w


def mlp_taylor_2(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams:
    """Value, first derivatives and second x-derivative of the MLP at x (N, 2).

    CPU tensors take the plain recurrence; anything else goes to the fused
    kernels (K1 forward, K2 backward), which raise on what they cannot take.
    """
    _check(spec)
    if x.device.type == "cpu":
        return mlp_taylor_2_reference(spec, params, x)
    return mlp_taylor2_kernel(spec, params, x)
