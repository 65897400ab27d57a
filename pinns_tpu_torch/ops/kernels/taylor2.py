"""Wrapper of the fused Taylor-2 CUDA kernel (``csrc/taylor2.cu``).

Replaces the TPU kernel ``mlp_taylor2_pallas`` (``_taylor2_kernel`` and the
lane-packed ``_taylor2_kernel_packed``; ``pinns_tpu/ops/pallas/fused_mlp.py``
at git ``89afc4b^``, lines 148-460). One launch computes (u, u_x, u_t, u_xx)
through the whole affine tanh MLP, keeping every activation stream in shared
memory; the plain PyTorch version is ``ops.taylor.mlp_taylor_2_reference``.

What bounds it on the H100: at width 200 the fp32 FMA issue rate (full fp32,
no tensor cores or TF32, by the numerics rule) and the shared-memory loads
that feed the FMAs; at width 20 and small N the launch and per-layer barrier
latency. The design answers with 16 FMAs per weight load (4 streams x 4
points a thread), streams kept on chip across all layers, one launch per call,
and a tile whose buffers fit half an SM's shared memory. The TPU kernel's
lane packing has no counterpart: the same CUDA kernel takes every width up to
256.

The wrapper validates everything the kernel assumes and raises otherwise;
it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params
from pinns_tpu_torch.ops.kernels import build

LAUNCHES = 0  # kernel launches in this process (chip_smoke.py reads it)
_launches_lock = threading.Lock()  # HTTP handler threads launch concurrently

MAX_WIDTH = 256
_POINTS_PER_THREAD = 4
_SMEM_PER_BLOCK = 112 * 1024  # two blocks per H100 SM (228 KB each)
_MAX_TILE = 128
_MAX_THREADS = 640  # the kernel's __launch_bounds__


def launch_config(layers: Sequence[int]) -> Tuple[int, int]:
    """(points per block, threads per block) for a net of these widths.

    The tile is the largest multiple of 4 points (at most 128) whose two
    ping-pong buffers of four streams fit ``_SMEM_PER_BLOCK``; the block gets
    one thread per (unit, 4-point group) of its widest layer, up to 640.
    """
    layers = tuple(int(w) for w in layers)
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"taylor2 kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    tile = _SMEM_PER_BLOCK // (4 * 2 * 4 * wmax) - 4  # bytes/(f32*bufs*streams*rows) - pad
    tile = min(_MAX_TILE, tile - tile % _POINTS_PER_THREAD)
    items = (tile // _POINTS_PER_THREAD) * max(layers[1:])
    threads = min(_MAX_THREADS, -(-items // 32) * 32)
    return tile, threads


def smem_bytes(layers: Sequence[int], tile: int) -> int:
    return 4 * 2 * 4 * max(layers) * (tile + 4)


def _lib():
    lib = build.load_library("taylor2")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pinns_taylor2_forward.argtypes = [
            p, i, p, p, i, f, f, f, f, i, i, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_forward.restype = i
        lib.pinns_cuda_error_string.argtypes = [i]
        lib.pinns_cuda_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def pack_params(params: Params) -> torch.Tensor:
    """W_0, b_0, W_1, b_1, ... flattened into one buffer, in kernel order."""
    return torch.cat(
        [t.reshape(-1) for layer in params for t in (layer["W"], layer["b"])]
    )


def taylor2(
    spec: MLPSpec, params: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, u_x, u_t, u_xx), each (N, out_dim) float32, from one kernel launch.

    ``x`` is the (N, 2) float32 raw points, contiguous on a CUDA device;
    ``params`` the JAX-layout layers on the same device. Raises on anything
    else.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"taylor2 kernel needs a CUDA tensor, got device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"taylor2 kernel takes float32 points, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 2 or spec.in_dim != 2:
        raise ValueError(f"taylor2 kernel takes (N, 2) points, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("taylor2 kernel needs contiguous points")
    if spec.mixed:
        raise ValueError("taylor2 kernel computes every stream in float32; "
                         "the mixed stream policy is slice 3")
    layers = spec.layers
    if len(params) != len(layers) - 1:
        raise ValueError(f"{len(params)} layers of params for widths {layers}")
    for i, (layer, din, dout) in enumerate(zip(params, layers[:-1], layers[1:])):
        for name, shape in (("W", (din, dout)), ("b", (1, dout))):
            t = layer[name]
            if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
                raise ValueError(
                    f"layer {i} {name}: want float32 {shape} on {x.device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
    tile, threads = launch_config(layers)
    flat = pack_params(params)
    n = x.shape[0]
    outs = tuple(
        torch.empty((n, spec.out_dim), dtype=torch.float32, device=x.device)
        for _ in range(4)
    )
    if n == 0:
        return outs
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.pinns_taylor2_forward(
        x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1,
        spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], tile, threads,
        *(o.data_ptr() for o in outs), x.device.index or 0, stream,
    )
    if err != 0:
        msg = lib.pinns_cuda_error_string(err).decode()
        raise RuntimeError(
            f"taylor2 kernel launch failed: CUDA error {err} ({msg}); "
            f"tile={tile} threads={threads} smem={smem_bytes(layers, tile)} B"
        )
    with _launches_lock:
        LAUNCHES += 1
    return outs
