"""Wrappers of the fused MLP forward CUDA kernel and its backward
(``csrc/mlp_forward.cu``), bound as one ``torch.autograd.Function``, and the
backward's algorithm in plain PyTorch.

Replaces the TPU kernel ``mlp_forward_pallas`` (``_forward_kernel``;
``pinns_tpu/ops/pallas/fused_mlp.py`` at git ``89afc4b^``, lines 92-146):
u = W_L tanh(... tanh(W_0 normalize(x) + b_0) ...) + b_L in one launch. The
TPU kernel had no VJP; the port differentiates the data misfit on the card,
so the backward (cotangent of u -> dW, db) is a hand-written kernel too. The
plain version of the forward is ``models.mlp.mlp_apply_reference``, of the
backward :func:`mlp_backward_reference`.

What bounds the kernels on the H100, and the design, are in the header of
``csrc/mlp_forward.cu``: one launch forward; the backward recomputes the
forward per tile, keeps the hidden outputs in an L2-resident scratch, and
reduces per-block partial gradients in block order (bit-for-bit repeatable).

The wrappers validate what the kernels assume and raise otherwise; on a CPU
tensor they raise too. They never fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params, normalize_inputs
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels.taylor2 import check_call, pack_params, split_grad

LAUNCHES = 0  # forward kernel launches in this process (chip_smoke.py reads it)
BACKWARD_LAUNCHES = 0  # backward calls (kernel + reduction) in this process
_launches_lock = threading.Lock()

MAX_WIDTH = 256
MAX_LAYERS = 32
_POINTS_PER_THREAD = 4
_FWD_SMEM = 112 * 1024  # two forward blocks per H100 SM
_BWD_SMEM = 200 * 1024
_FWD_MAX_TILE = 128
_BWD_MAX_TILE = 64
_FWD_MAX_THREADS = 640  # the forward kernel's __launch_bounds__
MAX_GRID = 264  # backward blocks: two per SM of an H100


def _tile(layers: Sequence[int], buffers: int, budget: int, cap: int) -> int:
    """Largest multiple of 4 points (at most ``cap``) whose ``buffers``
    activation buffers (widest rows x (tile + 4) floats) fit ``budget``."""
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"mlp_forward kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    tile = budget // (4 * buffers * wmax) - 4
    return min(cap, tile - tile % _POINTS_PER_THREAD)


def forward_config(layers: Sequence[int]) -> Tuple[int, int]:
    """(points per block, threads per block) of the forward kernel: one thread
    per (unit, 4-point group) of the widest layer, up to 640."""
    tile = _tile(layers, 2, _FWD_SMEM, _FWD_MAX_TILE)
    items = (tile // _POINTS_PER_THREAD) * max(layers[1:])
    return tile, min(_FWD_MAX_THREADS, -(-items // 32) * 32)


def backward_config(layers: Sequence[int], n: int) -> Tuple[int, int]:
    """(points per tile, blocks) of the backward kernel for n points."""
    tile = _tile(layers, 3, _BWD_SMEM, _BWD_MAX_TILE)
    return tile, max(1, min(MAX_GRID, -(-n // tile)))


def smem_bytes(layers: Sequence[int], tile: int, buffers: int) -> int:
    return 4 * buffers * max(layers) * (tile + 4)


def _lib():
    lib = build.load_library("mlp_forward")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pinns_mlp_forward.argtypes = [p, i, p, p, i, f, f, f, f, i, i, p, i, p]
        lib.pinns_mlp_forward.restype = i
        lib.pinns_mlp_backward.argtypes = [p, i, p, p, i, f, f, f, f, i, i, p, p, p, p, i, p]
        lib.pinns_mlp_backward.restype = i
        lib.pinns_mlp_error_string.argtypes = [i]
        lib.pinns_mlp_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def _check_spec(spec: MLPSpec) -> None:
    if spec.fourier or spec.n_paths:
        raise ValueError("mlp_forward kernel implements the plain normalize -> tanh model; "
                         "Fourier/path-embedded specs take the plain mlp_apply")
    if len(spec.layers) - 1 > MAX_LAYERS:
        raise ValueError(f"mlp_forward kernel takes up to {MAX_LAYERS} layers")


def _raise(lib, err: int, what: str, **cfg) -> None:
    msg = lib.pinns_mlp_error_string(err).decode()
    raise RuntimeError(f"mlp_forward {what} launch failed: CUDA error {err} ({msg}); {cfg}")


def mlp_forward(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """u = MLP(x), (N, out_dim) float32, from one kernel launch. ``x`` is the
    (N, 2) float32 raw points, contiguous on a CUDA device; ``params`` the
    JAX-layout layers on the same device. Raises on anything else."""
    global LAUNCHES
    _check_spec(spec)
    check_call("mlp_forward", spec, params, x)
    tile, threads = forward_config(spec.layers)
    n = x.shape[0]
    u = torch.empty((n, spec.out_dim), dtype=torch.float32, device=x.device)
    if n == 0:
        return u
    lib = _lib()
    layers = spec.layers
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    err = lib.pinns_mlp_forward(
        x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1,
        spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], tile, threads, u.data_ptr(),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        _raise(lib, err, "forward", tile=tile, threads=threads,
               smem=smem_bytes(layers, tile, 2))
    with _launches_lock:
        LAUNCHES += 1
    return u


def mlp_backward(spec: MLPSpec, params: Params, x: torch.Tensor,
                 g_out: torch.Tensor) -> torch.Tensor:
    """The flat gradient (``pack_params`` order) of sum over points of
    g_out . MLP(x), from the backward kernel and its block-order reduction.
    ``g_out`` is (N, out_dim) float32, contiguous, on ``x``'s device."""
    global BACKWARD_LAUNCHES
    _check_spec(spec)
    check_call("mlp_forward backward", spec, params, x, g_out)
    layers = spec.layers
    n = x.shape[0]
    grad = torch.empty(spec.n_params, dtype=torch.float32, device=x.device)
    if n == 0:
        return grad.zero_()
    tile, grid = backward_config(layers, n)
    partials = torch.empty((grid, spec.n_params), dtype=torch.float32, device=x.device)
    hstore = torch.empty(grid * (len(layers) - 2) * max(layers) * tile, dtype=torch.float32,
                         device=x.device)
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    err = lib.pinns_mlp_backward(
        x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1,
        spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], tile, grid, g_out.data_ptr(),
        partials.data_ptr(), hstore.data_ptr(), grad.data_ptr(), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        _raise(lib, err, "backward", tile=tile, grid=grid, smem=smem_bytes(layers, tile, 3))
    with _launches_lock:
        BACKWARD_LAUNCHES += 1
    return grad


class _MLPForward(torch.autograd.Function):
    """K5 forward, K5 backward as its VJP (w.r.t. the params only)."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        params = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        return mlp_forward(spec, params, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        x, *leaves = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the mlp_forward kernel's backward gives no gradient "
                                      "with respect to the input points")
        params = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        grad = mlp_backward(ctx.spec, params, x, g_out.contiguous())
        return (None, None, *split_grad(grad, leaves))


def mlp_apply_kernel(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """u = MLP(x) through K5, differentiable in the params through the K5
    backward. CUDA tensors only (the wrappers raise on anything else)."""
    leaves = [t for layer in params for t in (layer["W"], layer["b"])]
    return _MLPForward.apply(spec, x, *leaves)


def mlp_backward_reference(spec: MLPSpec, params: Params, x: torch.Tensor,
                           g_out: torch.Tensor) -> List[torch.Tensor]:
    """The backward kernel's algorithm in plain PyTorch: [dW_0, db_0, dW_1,
    ...] shaped like the params, of sum over points of g_out . MLP(x)."""
    acts = [normalize_inputs(spec, x)]  # the input of every layer
    for layer in params[:-1]:
        acts.append(torch.tanh(acts[-1] @ layer["W"] + layer["b"]))
    grads: List[torch.Tensor] = [None] * (2 * len(params))  # type: ignore[list-item]
    g = g_out
    for l in range(len(params) - 1, -1, -1):
        grads[2 * l] = acts[l].T @ g
        grads[2 * l + 1] = g.sum(dim=0, keepdim=True)
        if l > 0:
            g = (1.0 - acts[l] * acts[l]) * (g @ params[l]["W"].T)
    return grads
