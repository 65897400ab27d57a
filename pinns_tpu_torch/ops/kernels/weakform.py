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
launch on its counter. In the entropy mode (``entropy=True``: the entropy
penalty on the weak form, the coarse-cell battery) the same two launches
also give the weak entropy violation relu(e)^2 and take its cotangent; the
plain versions are those of ``ops.weakform`` with ``want_entropy``. The
wrappers take float32 CUDA tensors only and raise on anything else (CPU
tensors included: the plain versions are the CPU's), on Q > 8, and never
fall back to the plain versions.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from pinns_tpu_torch.device import constant
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels.taylor2 import FLOAT64_LATER
from pinns_tpu_torch.ops.weakform import EPS, gauss_legendre

EDGE_LAUNCHES = 0  # edge_points calls in this process (chip_smoke.py reads it)
LAUNCHES = 0  # flux_quadrature forward calls
BACKWARD_LAUNCHES = 0  # its backward calls (one host call issues both launches)
# the calls in the entropy mode, counted in LAUNCHES and BACKWARD_LAUNCHES too
ENTROPY_LAUNCHES = 0
ENTROPY_BACKWARD_LAUNCHES = 0
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
        lib.pinns_weakform_flux_forward.argtypes = [i, i, i, p, p, p, p, p, f, i, i, p, p, p, p,
                                                    i, p]
        lib.pinns_weakform_flux_forward.restype = i
        lib.pinns_weakform_flux_backward.argtypes = [
            i, i, i, p, p, p, p, p, p, p, p, f, i, i, p, p, p, p, i, p, i, p]
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
    if t.dtype == torch.float64:
        raise NotImplementedError(f"K7b: {name} is float64; K7b's float64 mode {FLOAT64_LATER}")
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flux_forward(kind: str, y: torch.Tensor, yx: Optional[torch.Tensor], hxe: torch.Tensor,
                 hte: torch.Tensor, coeffs: torch.Tensor, quad: int, entropy: bool = False,
                 gamma: float = 1.4):
    """r (N, C) from one launch: ``kind`` 'burgers' (C 1, ``coeffs`` =
    (lambda1, lambda2)) or 'euler' (C 3, (gamma - 1, visc)); ``y`` and
    ``yx`` (None when inviscid) the net at the edge points (N 4Q, C). With
    ``entropy``, (r, ent, e) from the same launch: the weak entropy
    violation ent = relu(e)^2 and e itself, each (N, 1) (``gamma`` is the
    Euler entropy's)."""
    global LAUNCHES, ENTROPY_LAUNCHES
    code, fields, n = _check_flux(kind, y, yx, hxe, hte, coeffs, quad)
    dev = y.device
    r = torch.empty((n, fields), dtype=torch.float32, device=dev)
    ent = torch.empty((n, 1), dtype=torch.float32, device=dev) if entropy else None
    e = torch.empty((n, 1), dtype=torch.float32, device=dev) if entropy else None
    if n > 0:
        lib = _lib()
        err = lib.pinns_weakform_flux_forward(
            code, int(yx is not None), int(entropy), y.data_ptr(), _ptr(yx), hxe.data_ptr(),
            hte.data_ptr(), coeffs.data_ptr(), float(gamma), n, quad,
            ctypes.cast(_host_floats(gauss_legendre(quad)[1]), ctypes.c_void_p), r.data_ptr(),
            _ptr(ent), _ptr(e), dev.index or 0, _stream(dev))
        if err != 0:
            _raise(lib, err, "flux forward")
        with _launches_lock:
            LAUNCHES += 1
            ENTROPY_LAUNCHES += int(entropy)
    return (r, ent, e) if entropy else r


def flux_backward(kind: str, g_r: torch.Tensor, y: torch.Tensor, yx: Optional[torch.Tensor],
                  hxe: torch.Tensor, hte: torch.Tensor, coeffs: torch.Tensor, quad: int,
                  g_ent: Optional[torch.Tensor] = None, e: Optional[torch.Tensor] = None,
                  gamma: float = 1.4):
    """(g_y, g_yx or None, g_coeffs (2,)) from g_r (N, C): the cotangents of
    the net at the edge points and the coefficients' gradient ((dlambda1,
    dlambda2) for Burgers, (0, dvisc) for Euler), summed over the cells in
    double in a fixed order. With ``g_ent`` (N, 1), the cotangent of the
    entropy violation, and ``e`` (N, 1), the forward's, the entropy's adjoint
    is added in the same launches. One host call, two launches."""
    global BACKWARD_LAUNCHES, ENTROPY_BACKWARD_LAUNCHES
    code, fields, n = _check_flux(kind, y, yx, hxe, hte, coeffs, quad)
    _check_tensor("g_r", g_r, (n, fields), y.device)
    if (g_ent is None) != (e is None):
        raise ValueError("K7b: the entropy's backward takes both g_ent and e")
    if g_ent is not None:
        _check_tensor("g_ent", g_ent, (n, 1), y.device)
        _check_tensor("e", e, (n, 1), y.device)
    gy = torch.empty_like(y)
    gyx = None if yx is None else torch.empty_like(yx)
    g_coeffs = torch.zeros(2, dtype=torch.float32, device=y.device)
    if n == 0:
        return gy, gyx, g_coeffs
    blocks = -(-n // BLOCK)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=y.device)
    lib = _lib()
    err = lib.pinns_weakform_flux_backward(
        code, int(yx is not None), int(g_ent is not None), g_r.data_ptr(), _ptr(g_ent), _ptr(e),
        y.data_ptr(), _ptr(yx), hxe.data_ptr(), hte.data_ptr(), coeffs.data_ptr(), float(gamma),
        n, quad, ctypes.cast(_host_floats(gauss_legendre(quad)[1]), ctypes.c_void_p),
        gy.data_ptr(), _ptr(gyx), partials.data_ptr(), blocks, g_coeffs.data_ptr(),
        y.device.index or 0, _stream(y.device))
    if err != 0:
        _raise(lib, err, "flux backward")
    with _launches_lock:
        BACKWARD_LAUNCHES += 1
        ENTROPY_BACKWARD_LAUNCHES += int(g_ent is not None)
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


class _FluxQuadratureEntropy(torch.autograd.Function):
    """K7b's quadrature in its entropy mode: (r, ent) from one launch, the
    backward kernel taking both cotangents."""

    @staticmethod
    def forward(ctx, kind, quad, gamma, y, yx, hxe, hte, coeffs):
        ctx.kind, ctx.quad, ctx.gamma = kind, quad, gamma
        r, ent, e = flux_forward(kind, y, yx, hxe, hte, coeffs, quad, True, gamma)
        ctx.save_for_backward(y, yx, hxe, hte, coeffs, e)
        return r, ent

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_r, g_ent):
        y, yx, hxe, hte, coeffs, e = ctx.saved_tensors
        gy, gyx, g_coeffs = flux_backward(ctx.kind, g_r.contiguous(), y, yx, hxe, hte, coeffs,
                                          ctx.quad, g_ent.contiguous(), e, ctx.gamma)
        return None, None, None, gy, gyx, None, None, g_coeffs


def flux_quadrature(kind: str, y: torch.Tensor, yx: Optional[torch.Tensor], hxe: torch.Tensor,
                    hte: torch.Tensor, coeffs: torch.Tensor, quad: int, entropy: bool = False,
                    gamma: float = 1.4):
    """r (N, C) through K7b, differentiable in ``y``, ``yx`` and ``coeffs``
    through its backward kernel; with ``entropy``, (r, ent (N, 1)) from the
    entropy mode (``gamma`` the Euler entropy's). CUDA tensors only."""
    if entropy:
        return _FluxQuadratureEntropy.apply(kind, quad, float(gamma), y, yx, hxe, hte, coeffs)
    return _FluxQuadrature.apply(kind, quad, y, yx, hxe, hte, coeffs)


def _slope(v: torch.Tensor, eps: float) -> torch.Tensor:
    """d max(v, eps) / dv: 1 above, half at a tie, 0 below."""
    return (v > eps).to(v.dtype) + 0.5 * (v == eps).to(v.dtype)


def _euler_entropy_adjoint(y3, yx3, gm1, gamma: float, c_eta, c_q, c_etax):
    """The Euler entropy pair's cotangents at rows (..., 3): c_eta on eta,
    c_q on q = u eta and c_etax on eta_x (None unless viscous) to (g_y,
    g_yx or None, eta_x or None), by the kernel's formulas
    (``csrc/weakform.cu::euler_entropy_row_backward``)."""
    eps = EPS
    rho, u, e = y3[..., 0:1], y3[..., 1:2], y3[..., 2:3]
    p = gm1 * (e - 0.5 * rho * u * u)
    big_p, big_r = torch.clamp(p, min=eps), torch.clamp(rho, min=eps)
    s = torch.log(big_p) - gamma * torch.log(big_r)
    eta = -rho * s / gm1
    c = c_eta + c_q * u
    g_rho, g_u, g_e = c * (-s / gm1), c_q * eta, torch.zeros_like(e)
    g_s = c * (-rho / gm1)
    g_bp, g_br = g_s / big_p, -g_s * gamma / big_r
    gx = eta_x = None
    if c_etax is not None:
        rho_x, u_x, e_x = yx3[..., 0:1], yx3[..., 1:2], yx3[..., 2:3]
        p_x = gm1 * (e_x - 0.5 * u * u * rho_x - rho * u * u_x)
        s_x = p_x / big_p - gamma * rho_x / big_r
        eta_x = -(rho_x * s + rho * s_x) / gm1
        g_s2, g_sx = c_etax * (-rho_x / gm1), c_etax * (-rho / gm1)
        g_rho = g_rho + c_etax * (-s_x / gm1)
        g_bp = g_bp + g_s2 / big_p - g_sx * p_x / (big_p * big_p)
        g_br = g_br - g_s2 * gamma / big_r + g_sx * gamma * rho_x / (big_r * big_r)
        g_px = g_sx / big_p
        g_rhox = c_etax * (-s / gm1) - g_sx * gamma / big_r - g_px * gm1 * 0.5 * u * u
        g_ux = -g_px * gm1 * rho * u
        g_ex = g_px * gm1
        g_u = g_u - g_px * gm1 * (u * rho_x + rho * u_x)
        g_rho = g_rho - g_px * gm1 * u * u_x
        gx = torch.cat([g_rhox, g_ux, g_ex], dim=-1)
    g_p = g_bp * _slope(p, eps)
    g_rho = g_rho + g_p * gm1 * (-0.5 * u * u) + g_br * _slope(rho, eps)
    g_u = g_u + g_p * gm1 * (-rho * u)
    g_e = g_e + g_p * gm1
    return torch.cat([g_rho, g_u, g_e], dim=-1), gx, eta_x


def flux_backward_reference(kind: str, g_r: torch.Tensor, y: torch.Tensor,
                            yx: Optional[torch.Tensor], hxe: torch.Tensor, hte: torch.Tensor,
                            coeffs: torch.Tensor, quad: int, g_ent: Optional[torch.Tensor] = None,
                            e: Optional[torch.Tensor] = None, gamma: float = 1.4):
    """K7b's backward in plain PyTorch, in ``y``'s dtype: (g_y, g_yx or None,
    g_coeffs (2,)) by the kernel's formulas. With a = g_r / (4 hxe hte), the
    cotangent of a top (bottom) edge's conserved variables is +(-) a hxe w_q,
    of a right (left) edge's fluxes +(-) a hte w_q; they go to (y, y_x) through
    the derivatives of U and F, and to the coefficients through F's. With
    ``g_ent`` and the forward's ``e``, the entropy's adjoint is added the same
    way, from a = g_ent 2 relu(e) / (4 hxe hte) through the entropy pair."""
    code, fields = KINDS[kind]
    n, q = hxe.shape[0], quad
    e_cell = e  # (the loops below name the edges e)
    w = constant(gauss_legendre(q)[1], y.dtype, y.device)
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
    if g_ent is not None:
        _entropy_backward_reference(code, g_ent, e_cell, y4, yx4, hxe, hte, c0, c1, w, gamma, gy,
                                    gyx, g_coeffs)
    return (gy.reshape(y.shape), None if yx is None else gyx.reshape(yx.shape), g_coeffs)


def _entropy_backward_reference(code, g_ent, e, y4, yx4, hxe, hte, c0, c1, w, gamma, gy, gyx,
                                g_coeffs) -> None:
    """The entropy's part of :func:`flux_backward_reference`, added in place
    to gy, gyx (n, 4, Q, C) and g_coeffs."""
    a = g_ent * 2.0 * torch.clamp(e, min=0.0) / (4.0 * hxe * hte)  # (N, 1)
    gce = (a * hxe)[:, :, None] * w[None, None, :]  # (N, 1, Q): eta top +, bottom -
    gfe = (a * hte)[:, :, None] * w[None, None, :]  # G right +, left -
    gce, gfe = gce.transpose(1, 2), gfe.transpose(1, 2)  # (N, Q, 1)
    if code == 0:  # eta = u^2 / 2, G = lambda1 u^3 / 3 - lambda2 u u_x
        for edge, sign in ((0, -1.0), (1, 1.0)):
            gy[:, edge] += sign * gce * y4[:, edge]
        for edge, sign in ((2, -1.0), (3, 1.0)):
            g, u = sign * gfe, y4[:, edge]
            gy[:, edge] += g * c0 * u * u
            g_coeffs[0] += torch.sum(g * u * u * u) / 3.0
            if yx4 is not None:
                ux = yx4[:, edge]
                gy[:, edge] -= g * c1 * ux
                gyx[:, edge] -= g * c1 * u
                g_coeffs[1] -= torch.sum(g * u * ux)
        return
    for edge, sign in ((0, -1.0), (1, 1.0)):
        g_y, _, _ = _euler_entropy_adjoint(y4[:, edge], None, c0, gamma, sign * gce, 0.0, None)
        gy[:, edge] += g_y
    for edge, sign in ((2, -1.0), (3, 1.0)):
        g = sign * gfe
        viscous = yx4 is not None
        g_y, g_yx, eta_x = _euler_entropy_adjoint(y4[:, edge], yx4[:, edge] if viscous else None,
                                                  c0, gamma, 0.0, g, -c1 * g if viscous else None)
        gy[:, edge] += g_y
        if viscous:
            gyx[:, edge] += g_yx
            g_coeffs[1] -= torch.sum(g * eta_x)
