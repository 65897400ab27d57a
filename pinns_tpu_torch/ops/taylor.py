"""Taylor-mode derivative streams through the tanh MLP (port of
``pinns_tpu/ops/taylor.py::mlp_taylor_2`` and ``mlp_taylor_1``).

One forward pass carries (value, d/dx, d/dt, d2/dx2) layer by layer:

  P = H  @ W + b          Px = Hx @ W        Pt = Ht @ W        Pxx = Hxx @ W
  s = tanh(P)             s' = 1 - s^2       s'' = -2 s s'
  H = s                   Hx = s' Px         Ht = s' Pt         Hxx = s'' Px^2 + s' Pxx

Mixed precision (``spec.compute_dtype``, e.g. bfloat16) follows the JAX
package's per-stream policy (``_StreamPolicy``): a quantized stream is stored
in the compute dtype at each layer boundary and its matmul multiplies the
stored values by the compute-dtype weights with float32 accumulation; the
first layer consumes exact coordinates; ``keep_streams`` ('value', 'xx')
exempts streams; ``mixed_elementwise`` also rounds the quantized streams' dot
outputs, so their elementwise ops run in the compute dtype. The x and t
derivative streams ("deriv") are quantized whenever the spec is mixed.

``mlp_taylor_2`` dispatches on the device of ``x``: a CPU tensor runs the
plain PyTorch recurrence (``mlp_taylor_2_reference``); a CUDA tensor runs the
fused kernel K1 (float32, or its float64 mode for a narrow float64 spec:
``polish``) or K6 (the mixed policy on float32 masters), each
differentiable in the params through its backward kernel
(``ops.kernels.taylor2``). Each either launches or raises.

``mlp_taylor_1`` carries the first-order streams only (value, d/dx, d/dt:
the Euler residuals need no second derivative):

  P = H @ W + b    Px = Hx @ W    Pt = Ht @ W
  H = tanh(P)      Hx = (1 - H^2) Px    Ht = (1 - H^2) Pt

with the same dispatch: the plain recurrence (``mlp_taylor_1_reference``) on
the CPU, kernel K7a and its backward (``ops.kernels.taylor1``) on a CUDA
tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params, embed_streams, normalize_inputs

Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Streams1 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the policy's name for each of the four streams (u, u_x, u_t, u_xx)
POLICY_STREAMS = ("value", "deriv", "deriv", "xx")


class _StreamPolicy:
    """Per-stream mixed-precision policy (``pinns_tpu/ops/taylor.py:55-88``).

    ``store`` quantizes a stream at the layer boundary (identity for kept
    streams and unmixed specs); ``act`` rounds a dot output to the compute
    dtype under ``mixed_elementwise``; ``dot`` multiplies a quantized stream by
    the compute-dtype weights with float32 accumulation. PyTorch's bf16 matmul
    would round its output to bf16 (JAX's ``preferred_element_type`` does
    not), so the operands are upcast and multiplied in ``spec.dtype``.
    """

    def __init__(self, spec: MLPSpec):
        self.spec = spec
        self.cdtype = spec.cdtype

    def quantized(self, stream: str) -> bool:
        return self.spec.mixed and stream not in self.spec.keep_streams

    def store(self, v, stream: str):
        return v.to(self.cdtype) if self.quantized(stream) else v

    def act(self, v, stream: str, first: bool = False):
        if first or not (self.quantized(stream) and self.spec.mixed_elementwise):
            return v
        return v.to(self.cdtype)

    def dot(self, h, w, stream: str, first: bool = False):
        if first or not self.quantized(stream):
            return h @ w
        dtype = self.spec.dtype
        return h.to(dtype) @ w.to(self.cdtype).to(dtype)

    def weight(self, w, stream: str):
        """The weights ``dot`` multiplies this stream by after the first
        layer, in ``spec.dtype``."""
        if not self.quantized(stream):
            return w
        return w.to(self.cdtype).to(self.spec.dtype)


def _check(spec: MLPSpec, name: str = "mlp_taylor_2") -> None:
    if spec.in_dim != 2:
        raise ValueError(f"{name} expects in_dim == 2 (x, t)")


def taylor2_layer(pol: _StreamPolicy, streams, w, b, first: bool):
    """One hidden layer under the policy: the pre-activation streams after
    ``act`` (p, px, pt, pxx), the tanh factors (s, s', s'') and the stored
    output streams. ``streams[3]`` may be None (the affine embedding's zero
    curvature stream), in the JAX package's operation order."""
    h, hx, ht, hxx = streams
    p = pol.act(pol.dot(h, w, "value", first) + b, "value", first)
    px = pol.act(pol.dot(hx, w, "deriv", first), "deriv", first)
    pt = pol.act(pol.dot(ht, w, "deriv", first), "deriv", first)
    pxx = None if hxx is None else pol.act(pol.dot(hxx, w, "xx", first), "xx", first)
    s = torch.tanh(p)
    sp = 1.0 - s * s
    spp = -2.0 * s * sp
    out = (
        pol.store(s, "value"),
        pol.store(sp * px, "deriv"),
        pol.store(sp * pt, "deriv"),
        pol.store(spp * px * px if pxx is None else spp * px * px + sp * pxx, "xx"),
    )
    return (p, px, pt, pxx), (s, sp, spp), out


def mlp_taylor_2_reference(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams:
    """(y, y_x, y_t, y_xx), each (N, out_dim) in ``spec.dtype``: the plain
    PyTorch recurrence under the spec's stream policy, on ``x``'s device
    (float32 matmuls, TF32 off)."""
    _check(spec)
    pol = _StreamPolicy(spec)
    # hxx is None (identically zero) for the affine embedding; per point
    # (N, embed_dim) streams with shock paths
    streams = embed_streams(spec, normalize_inputs(spec, x), params[0])
    for i, layer in enumerate(params[:-1]):
        # the first layer consumes exact coordinates: never quantized
        _, _, streams = taylor2_layer(pol, streams, layer["W"], layer["b"], i == 0)
    h, hx, ht, hxx = streams
    w, b = params[-1]["W"], params[-1]["b"]
    return (pol.dot(h, w, "value") + b, pol.dot(hx, w, "deriv"), pol.dot(ht, w, "deriv"),
            pol.dot(hxx, w, "xx"))


def mlp_taylor_2(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams:
    """Value, first derivatives and second x-derivative of the MLP at x (N, 2).

    CPU tensors take the plain recurrence; anything else goes to the fused
    kernels (K1/K2 for a float32 spec and their float64 modes for a narrow
    float64 one, K6 forward and backward for a mixed one), which raise on
    what they cannot take.
    """
    _check(spec)
    if x.device.type == "cpu":
        return mlp_taylor_2_reference(spec, params, x)
    from pinns_tpu_torch.ops.kernels.taylor2 import mlp_taylor2_kernel

    return mlp_taylor2_kernel(spec, params, x)


def taylor1_layer(pol: _StreamPolicy, streams, w, b, first: bool):
    """One hidden layer of the first-order recurrence under the policy: the
    pre-activation streams after ``act`` (p, px, pt), the tanh factors
    (s, s') and the stored output streams, in the JAX package's operation
    order (``pinns_tpu/ops/taylor.py:114-124``)."""
    h, hx, ht = streams
    p = pol.act(pol.dot(h, w, "value", first) + b, "value", first)
    px = pol.act(pol.dot(hx, w, "deriv", first), "deriv", first)
    pt = pol.act(pol.dot(ht, w, "deriv", first), "deriv", first)
    s = torch.tanh(p)
    sp = 1.0 - s * s
    out = (pol.store(s, "value"), pol.store(sp * px, "deriv"), pol.store(sp * pt, "deriv"))
    return (p, px, pt), (s, sp), out


def mlp_taylor_1_reference(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams1:
    """(y, y_x, y_t), each (N, out_dim) in ``spec.dtype``: the plain PyTorch
    first-order recurrence (``pinns_tpu/ops/taylor.py:91-129``) on ``x``'s
    device, the derivatives taken w.r.t. the raw (x, t) through the input
    rescale."""
    _check(spec, "mlp_taylor_1")
    pol = _StreamPolicy(spec)
    h, hx, ht, _ = embed_streams(spec, normalize_inputs(spec, x), params[0])
    streams = (h, hx, ht)
    for i, layer in enumerate(params[:-1]):
        # the first layer consumes exact coordinates: never quantized
        _, _, streams = taylor1_layer(pol, streams, layer["W"], layer["b"], i == 0)
    h, hx, ht = streams
    w, b = params[-1]["W"], params[-1]["b"]
    y_x, y_t = pol.dot(hx, w, "deriv"), pol.dot(ht, w, "deriv")
    n = x.shape[0]
    # a net without hidden layers keeps (1, out) tangent rows: broadcast them
    return pol.dot(h, w, "value") + b, y_x.expand(n, -1), y_t.expand(n, -1)


def mlp_taylor_1(spec: MLPSpec, params: Params, x: torch.Tensor) -> Streams1:
    """Value and first derivatives along x and t of the MLP at x (N, 2).

    CPU tensors take the plain recurrence; anything else goes to the fused
    kernel K7a, differentiable in the params through its backward kernel
    (``ops.kernels.taylor1``), which raises on what it cannot take.
    """
    _check(spec, "mlp_taylor_1")
    if x.device.type == "cpu":
        return mlp_taylor_1_reference(spec, params, x)
    from pinns_tpu_torch.ops.kernels.taylor1 import mlp_taylor1_kernel

    return mlp_taylor1_kernel(spec, params, x)
