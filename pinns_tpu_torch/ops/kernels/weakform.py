"""Wrapper of K7b, the weak-form flux quadrature (``csrc/weakform.cu``): the
cells' edge points, and the cell-mean residuals from the net's values at
them with their backward, bound as one ``torch.autograd.Function``.

K7b replaces the XLA programs of ``pinns_tpu/ops/weakform.py::
burgers_flux_residual`` (``:87``) and ``euler_flux_residuals`` (``:182``)
around the net (JAX had no Pallas kernel for them). Its plain versions are
``ops.weakform.edge_points_reference``, ``burgers_quadrature_reference`` and
``euler_quadrature_reference`` (backward by autograd through them).

A training step of a weak-form preset issues three host calls here:
:func:`edge_points` (one launch), the forward of :func:`flux_quadrature`
(one launch) and its backward (two launches: the per-cell pass and the fixed
order sum of the coefficient gradient's per-block partials). Each counts one
launch on its counter. The wrappers take float32 CUDA tensors only and raise
on anything else (CPU tensors included: the plain versions are the CPU's),
on Q > 8, and never fall back to the plain versions. The entropy of slice
2b-iii is not computed here (``ops.weakform`` raises before calling).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.weakform import gauss_legendre

EDGE_LAUNCHES = 0  # edge_points calls in this process (chip_smoke.py reads it)
LAUNCHES = 0  # flux_quadrature forward calls
BACKWARD_LAUNCHES = 0  # its backward calls (one host call issues both launches)
_launches_lock = threading.Lock()

MAX_QUAD = 8
BLOCK = 256  # threads a block of the per-cell kernels (kBlock in the source)
KINDS = {"burgers": (0, 1), "euler": (1, 3)}  # kind -> (code, fields)


def _lib():
    lib = build.load_library("weakform")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pinns_weakform_edge_points.argtypes = [p, i, i, f, f, f, f, f, f, p, p, p, p, i, p]
        lib.pinns_weakform_edge_points.restype = i
        lib.pinns_weakform_flux_forward.argtypes = [i, i, p, p, p, p, p, i, i, p, p, i, p]
        lib.pinns_weakform_flux_forward.restype = i
        lib.pinns_weakform_flux_backward.argtypes = [
            i, i, p, p, p, p, p, p, i, i, p, p, p, p, i, p, i, p]
        lib.pinns_weakform_flux_backward.restype = i
        lib.pinns_weakform_error_string.argtypes = [i]
        lib.pinns_weakform_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def _check_quad(quad: int) -> None:
    if not 1 <= quad <= MAX_QUAD:
        raise ValueError(f"the flux kernel (K7b) takes 1 to {MAX_QUAD} quadrature nodes, "
                         f"got {quad}")


def _check_tensor(name: str, t: torch.Tensor, shape, device=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"K7b takes CUDA tensors ({name} is on {t.device}); the plain "
                         "versions in ops.weakform are the CPU's")
    if t.dtype != torch.float32:
        raise ValueError(f"K7b takes float32 tensors ({name} is {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"K7b: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"K7b: {name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"K7b: {name} is on {t.device}, the call on {device}")


def _host_floats(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*(float(v) for v in values))


def _raise(lib, err: int, what: str) -> None:
    msg = lib.pinns_weakform_error_string(err).decode()
    raise RuntimeError(f"weakform {what} launch failed: CUDA error {err} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def edge_points(spec: MLPSpec, centers: torch.Tensor, hx: float, ht: float, quad: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pts (N 4Q, 2), hxe (N, 1), hte (N, 1)) of the cells centred at
    ``centers`` (N, 2), float32 on a CUDA device, from one launch; equal bit
    for bit to ``ops.weakform.edge_points_reference`` on the card."""
    global EDGE_LAUNCHES
    _check_quad(quad)
    n = centers.shape[0]
    _check_tensor("centers", centers, (n, 2))
    dev = centers.device
    pts = torch.empty((n * 4 * quad, 2), dtype=torch.float32, device=dev)
    hxe = torch.empty((n, 1), dtype=torch.float32, device=dev)
    hte = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if n == 0:
        return pts, hxe, hte
    lib = _lib()
    err = lib.pinns_weakform_edge_points(
        centers.data_ptr(), n, quad, spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], hx, ht,
        ctypes.cast(_host_floats(gauss_legendre(quad)[0]), ctypes.c_void_p), pts.data_ptr(),
        hxe.data_ptr(), hte.data_ptr(), dev.index or 0, _stream(dev))
    if err != 0:
        _raise(lib, err, "edge_points")
    with _launches_lock:
        EDGE_LAUNCHES += 1
    return pts, hxe, hte


def _check_flux(kind: str, y, yx, hxe, hte, coeffs, quad: int) -> Tuple[int, int, int]:
    """(kind code, fields, cells) after checking a quadrature call's inputs."""
    if kind not in KINDS:
        raise ValueError(f"K7b: unknown equation {kind!r}; expected one of {sorted(KINDS)}")
    _check_quad(quad)
    code, fields = KINDS[kind]
    n = hxe.shape[0]
    dev = y.device
    _check_tensor("y", y, (n * 4 * quad, fields))
    if yx is not None:
        _check_tensor("y_x", yx, (n * 4 * quad, fields), dev)
    _check_tensor("hxe", hxe, (n, 1), dev)
    _check_tensor("hte", hte, (n, 1), dev)
    _check_tensor("coeffs", coeffs, (2,), dev)
    return code, fields, n


def flux_forward(kind: str, y: torch.Tensor, yx: Optional[torch.Tensor], hxe: torch.Tensor,
                 hte: torch.Tensor, coeffs: torch.Tensor, quad: int) -> torch.Tensor:
    """r (N, C) from one launch: ``kind`` 'burgers' (C 1, ``coeffs`` =
    (lambda1, lambda2)) or 'euler' (C 3, (gamma - 1, visc)); ``y`` and
    ``yx`` (None when inviscid) the net at the edge points (N 4Q, C)."""
    global LAUNCHES
    code, fields, n = _check_flux(kind, y, yx, hxe, hte, coeffs, quad)
    r = torch.empty((n, fields), dtype=torch.float32, device=y.device)
    if n == 0:
        return r
    lib = _lib()
    err = lib.pinns_weakform_flux_forward(
        code, int(yx is not None), y.data_ptr(), None if yx is None else yx.data_ptr(),
        hxe.data_ptr(), hte.data_ptr(), coeffs.data_ptr(), n, quad,
        ctypes.cast(_host_floats(gauss_legendre(quad)[1]), ctypes.c_void_p), r.data_ptr(),
        y.device.index or 0, _stream(y.device))
    if err != 0:
        _raise(lib, err, "flux forward")
    with _launches_lock:
        LAUNCHES += 1
    return r


def flux_backward(kind: str, g_r: torch.Tensor, y: torch.Tensor, yx: Optional[torch.Tensor],
                  hxe: torch.Tensor, hte: torch.Tensor, coeffs: torch.Tensor, quad: int):
    """(g_y, g_yx or None, g_coeffs (2,)) from g_r (N, C): the cotangents of
    the net at the edge points and the coefficients' gradient ((dlambda1,
    dlambda2) for Burgers, (0, dvisc) for Euler), summed over the cells in
    double in a fixed order. One host call, two launches."""
    global BACKWARD_LAUNCHES
    code, fields, n = _check_flux(kind, y, yx, hxe, hte, coeffs, quad)
    _check_tensor("g_r", g_r, (n, fields), y.device)
    gy = torch.empty_like(y)
    gyx = None if yx is None else torch.empty_like(yx)
    g_coeffs = torch.zeros(2, dtype=torch.float32, device=y.device)
    if n == 0:
        return gy, gyx, g_coeffs
    blocks = -(-n // BLOCK)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=y.device)
    lib = _lib()
    err = lib.pinns_weakform_flux_backward(
        code, int(yx is not None), g_r.data_ptr(), y.data_ptr(),
        None if yx is None else yx.data_ptr(), hxe.data_ptr(), hte.data_ptr(),
        coeffs.data_ptr(), n, quad,
        ctypes.cast(_host_floats(gauss_legendre(quad)[1]), ctypes.c_void_p), gy.data_ptr(),
        None if gyx is None else gyx.data_ptr(), partials.data_ptr(), blocks,
        g_coeffs.data_ptr(), y.device.index or 0, _stream(y.device))
    if err != 0:
        _raise(lib, err, "flux backward")
    with _launches_lock:
        BACKWARD_LAUNCHES += 1
    return gy, gyx, g_coeffs


class _FluxQuadrature(torch.autograd.Function):
    """K7b's quadrature, its backward kernel as the VJP with respect to the
    net's values, their x-derivatives and the coefficients (the half-widths
    come from the centers, which take no gradient)."""

    @staticmethod
    def forward(ctx, kind, quad, y, yx, hxe, hte, coeffs):
        ctx.kind, ctx.quad = kind, quad
        ctx.save_for_backward(y, yx, hxe, hte, coeffs)
        return flux_forward(kind, y, yx, hxe, hte, coeffs, quad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_r):
        y, yx, hxe, hte, coeffs = ctx.saved_tensors
        gy, gyx, g_coeffs = flux_backward(ctx.kind, g_r.contiguous(), y, yx, hxe, hte, coeffs,
                                          ctx.quad)
        return None, None, gy, gyx, None, None, g_coeffs


def flux_quadrature(kind: str, y: torch.Tensor, yx: Optional[torch.Tensor], hxe: torch.Tensor,
                    hte: torch.Tensor, coeffs: torch.Tensor, quad: int) -> torch.Tensor:
    """r (N, C) through K7b, differentiable in ``y``, ``yx`` and ``coeffs``
    through its backward kernel. CUDA tensors only."""
    return _FluxQuadrature.apply(kind, quad, y, yx, hxe, hte, coeffs)


def flux_backward_reference(kind: str, g_r: torch.Tensor, y: torch.Tensor,
                            yx: Optional[torch.Tensor], hxe: torch.Tensor, hte: torch.Tensor,
                            coeffs: torch.Tensor, quad: int):
    """K7b's backward in plain PyTorch, in ``y``'s dtype: (g_y, g_yx or None,
    g_coeffs (2,)) by the kernel's formulas. With a = g_r / (4 hxe hte), the
    cotangent of a top (bottom) edge's conserved variables is +(-) a hxe w_q,
    of a right (left) edge's fluxes +(-) a hte w_q; they go to (y, y_x) through
    the derivatives of U and F, and to the coefficients through F's."""
    code, fields = KINDS[kind]
    n, q = hxe.shape[0], quad
    w = torch.as_tensor(gauss_legendre(q)[1], dtype=y.dtype).to(y.device)
    a = g_r / (4.0 * hxe * hte)  # (N, C)
    gc = (a * hxe)[:, None, :] * w[None, :, None]  # (N, Q, C): top +, bottom -
    gf = (a * hte)[:, None, :] * w[None, :, None]  # right +, left -
    y4 = y.reshape(n, 4, q, fields)
    yx4 = None if yx is None else yx.reshape(n, 4, q, fields)
    gy = torch.zeros_like(y4)
    gyx = None if yx is None else torch.zeros_like(yx4)
    g_coeffs = torch.zeros(2, dtype=y.dtype, device=y.device)
    c0, c1 = coeffs[0], coeffs[1]
    signs = {0: -1.0, 1: 1.0, 2: -1.0, 3: 1.0}
    if code == 0:  # Burgers: U = u, F = lambda1 u^2 / 2 - lambda2 u_x
        gy[:, 0], gy[:, 1] = -gc, gc
        for e in (2, 3):
            g = signs[e] * gf
            u = y4[:, e]
            gy[:, e] = g * c0 * u
            g_coeffs[0] += torch.sum(g * 0.5 * u * u)
            if yx is not None:
                gyx[:, e] = -c1 * g
                g_coeffs[1] -= torch.sum(g * yx4[:, e])
    else:  # Euler: U = (rho, rho u, E), F = (rho u, rho u^2 + p, u (E + p)) - visc U_x
        gm1 = c0
        for e in (0, 1):
            g = signs[e] * gc
            rho, u = y4[:, e, :, 0:1], y4[:, e, :, 1:2]
            gy[:, e] = torch.cat([g[..., 0:1] + g[..., 1:2] * u, g[..., 1:2] * rho,
                                  g[..., 2:3]], dim=-1)
        for e in (2, 3):
            g = signs[e] * gf
            g0, g1, g2 = g[..., 0:1], g[..., 1:2], g[..., 2:3]
            rho, u, en = y4[:, e, :, 0:1], y4[:, e, :, 1:2], y4[:, e, :, 2:3]
            p = gm1 * (en - 0.5 * rho * u * u)
            dp_drho, dp_du = -0.5 * gm1 * u * u, -gm1 * rho * u
            g_rho = g0 * u + g1 * (u * u + dp_drho) + g2 * u * dp_drho
            g_u = g0 * rho + g1 * (2.0 * rho * u + dp_du) + g2 * ((en + p) + u * dp_du)
            g_e = g1 * gm1 + g2 * u * (1.0 + gm1)
            if yx is not None:
                rho_x, u_x, e_x = yx4[:, e, :, 0:1], yx4[:, e, :, 1:2], yx4[:, e, :, 2:3]
                g_rho = g_rho - c1 * g1 * u_x
                g_u = g_u - c1 * g1 * rho_x
                gyx[:, e] = torch.cat([-c1 * (g0 + g1 * u), -c1 * g1 * rho, -c1 * g2], dim=-1)
                g_coeffs[1] -= torch.sum(g0 * rho_x + g1 * (rho_x * u + rho * u_x) + g2 * e_x)
            gy[:, e] = torch.cat([g_rho, g_u, g_e], dim=-1)
    return (gy.reshape(y.shape), None if yx is None else gyx.reshape(yx.shape), g_coeffs)
