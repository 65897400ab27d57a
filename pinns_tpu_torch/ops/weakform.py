"""Weak-form (finite-volume) flux residuals over space-time control volumes
(port of ``pinns_tpu/ops/weakform.py``, whose docstring derives them).

For each control volume [x1, x2] x [t1, t2] centred at a collocation point
(half-widths ``hx``, ``ht``, clipped to the domain),

    r = [ int_x (u(x, t2) - u(x, t1)) dx + int_t (F(x2, t) - F(x1, t)) dt ] / |cell|

with Q-node Gauss-Legendre quadrature on each edge. Every cell's 4Q edge
points go through the net in one pass, in JAX's row order
``cell * 4Q + edge * Q + q`` with the edges [bottom t1, top t2, left x1,
right x2]. Burgers: F = lambda1 u^2 / 2 - lambda2 u_x. Euler: the conserved
variables (rho, rho u, E) and fluxes (rho u, rho u^2 + p, u (E + p)), with
the artificial viscosity -visc dU/dx on the side edges when ``viscous``.

The functions split into three stages, each with a plain PyTorch version
here: the edge points (:func:`edge_points_reference`), the net at those
points (the Taylor-1 streams when viscous, else the forward pass), and the
quadrature (:func:`burgers_quadrature_reference`,
:func:`euler_quadrature_reference`, which also give the weak entropy
violation). ``burgers_flux_residual`` and ``euler_flux_residuals`` dispatch
on the device of the centers, as ``ops.taylor.mlp_taylor_1`` does: a CPU
tensor (or ``plain=True``) takes the plain versions; any other goes to
kernel K7b's edge-point kernel, then K7a (viscous) or K5 (inviscid), then
K7b's quadrature kernel, differentiable through its backward
(``ops.kernels.weakform``), the entropy violation from its entropy mode.
The clamps of p and rho under the Euler entropy's logs are
``torch.maximum``, whose gradient at a tie is half, as JAX's
``jnp.maximum``.

The quadrature sums run over q in order, in float32, in the operation order
of the JAX package's expressions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pinns_tpu_torch.device import constant
from pinns_tpu_torch.models.mlp import MLPSpec, Params, mlp_apply, mlp_apply_reference
from pinns_tpu_torch.ops.taylor import mlp_taylor_1, mlp_taylor_1_reference

EPS = 1e-3  # the floor of p and rho under the Euler entropy's logs


def gauss_legendre(q: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Q-point Gauss-Legendre nodes and weights on [-1, 1], float64."""
    nodes, weights = np.polynomial.legendre.leggauss(q)
    return nodes.astype(np.float64), weights.astype(np.float64)


def _consts(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return constant(values, like.dtype, like.device)


def cell_edges(spec: MLPSpec, centers: torch.Tensor, hx: float, ht: float):
    """The cells clipped to the domain: (x1, x2, t1, t2), each (N, 1)."""
    lbx, lbt = spec.lb
    ubx, ubt = spec.ub
    x1 = torch.clamp(centers[:, 0:1] - hx, min=lbx)
    x2 = torch.clamp(centers[:, 0:1] + hx, max=ubx)
    t1 = torch.clamp(centers[:, 1:2] - ht, min=lbt)
    t2 = torch.clamp(centers[:, 1:2] + ht, max=ubt)
    return x1, x2, t1, t2


def edge_points_reference(spec: MLPSpec, centers: torch.Tensor, hx: float, ht: float,
                          quad: int):
    """(pts, hxe, hte): the (N * 4Q, 2) quadrature points of every cell in
    JAX's row order, and the clipped half-widths (N, 1)."""
    x1, x2, t1, t2 = cell_edges(spec, centers, hx, ht)
    g = _consts(gauss_legendre(quad)[0], centers)
    xm, hxe = 0.5 * (x1 + x2), 0.5 * (x2 - x1)
    tm, hte = 0.5 * (t1 + t2), 0.5 * (t2 - t1)
    xq = xm + hxe * g  # (N, Q)
    tq = tm + hte * g
    one = torch.ones_like(xq)
    bot = torch.stack([xq, t1 * one], dim=-1)
    top = torch.stack([xq, t2 * one], dim=-1)
    lef = torch.stack([x1 * one, tq], dim=-1)
    rig = torch.stack([x2 * one, tq], dim=-1)
    pts = torch.cat([bot, top, lef, rig], dim=1)
    return pts.reshape(-1, 2), hxe, hte


def quad_sum(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_q w_q vals[:, q] for vals (N, Q, C), the products summed over q in
    order (K7b's order)."""
    acc = vals[:, 0] * w[0]
    for q in range(1, vals.shape[1]):
        acc = acc + vals[:, q] * w[q]
    return acc


def burgers_quadrature_reference(u, ux, hxe, hte, lambda1, lambda2, quad: int,
                                 want_entropy: bool = False):
    """(r, ent) of Burgers from the net at the edge points: ``u`` and ``ux``
    (None when inviscid) (N * 4Q, 1), the half-widths (N, 1). ent is the
    weak entropy violation relu(E)^2 (N, 1), or None."""
    q = quad
    n = hxe.shape[0]
    u = u.reshape(n, 4 * q, 1)
    ux = None if ux is None else ux.reshape(n, 4 * q, 1)
    w = _consts(gauss_legendre(q)[1], u)
    u_bot, u_top = u[:, 0:q], u[:, q:2 * q]
    u_lef, u_rig = u[:, 2 * q:3 * q], u[:, 3 * q:4 * q]
    flux_lef = 0.5 * lambda1 * u_lef * u_lef
    flux_rig = 0.5 * lambda1 * u_rig * u_rig
    if ux is not None:
        flux_lef = flux_lef - lambda2 * ux[:, 2 * q:3 * q]
        flux_rig = flux_rig - lambda2 * ux[:, 3 * q:4 * q]
    measure = 4.0 * hxe * hte
    r = (hxe * quad_sum(u_top - u_bot, w) + hte * quad_sum(flux_rig - flux_lef, w)) / measure
    ent = None
    if want_entropy:
        ent_u = 0.5 * (u_top * u_top - u_bot * u_bot)
        ent_g = (lambda1 / 3.0) * (u_rig * u_rig * u_rig - u_lef * u_lef * u_lef)
        if ux is not None:
            # the viscous entropy flux -lambda2 u u_x on the side edges
            ent_g = ent_g - lambda2 * (u_rig * ux[:, 3 * q:4 * q] - u_lef * ux[:, 2 * q:3 * q])
        e = (hxe * quad_sum(ent_u, w) + hte * quad_sum(ent_g, w)) / measure
        ent = torch.clamp(e, min=0.0) ** 2
    return r, ent


def _floor(v: torch.Tensor, eps: float) -> torch.Tensor:
    """max(v, eps), half the gradient at a tie (JAX's ``jnp.maximum``)."""
    return torch.maximum(v, constant(eps, v.dtype, v.device))


def euler_entropy_x(y, y_x, gamma: float, eps: float = EPS):
    """d(eta)/dx along an edge from the primitive fields and their
    x-derivatives (``pinns_tpu/ops/weakform.py:154``)."""
    rho, u, e = y[..., 0:1], y[..., 1:2], y[..., 2:3]
    rho_x, u_x, e_x = y_x[..., 0:1], y_x[..., 1:2], y_x[..., 2:3]
    p = (gamma - 1.0) * (e - 0.5 * rho * u * u)
    p_safe = _floor(p, eps)
    rho_safe = _floor(rho, eps)
    p_x = (gamma - 1.0) * (e_x - 0.5 * u * u * rho_x - rho * u * u_x)
    s = torch.log(p_safe) - gamma * torch.log(rho_safe)
    s_x = p_x / p_safe - gamma * rho_x / rho_safe
    return -(rho_x * s + rho * s_x) / (gamma - 1.0)


def euler_conserved_flux(y, gamma: float, eps: float = EPS):
    """(U, F, eta, q): the conserved variables, their fluxes, and the convex
    entropy pair of the gamma law (``pinns_tpu/ops/weakform.py:168``)."""
    rho, u, e = y[..., 0:1], y[..., 1:2], y[..., 2:3]
    p = (gamma - 1.0) * (e - 0.5 * rho * u * u)
    cons = torch.cat([rho, rho * u, e], dim=-1)
    flux = torch.cat([rho * u, rho * u * u + p, u * (e + p)], dim=-1)
    s = torch.log(_floor(p, eps)) - gamma * torch.log(_floor(rho, eps))
    eta = -rho * s / (gamma - 1.0)
    return cons, flux, eta, u * eta


def euler_quadrature_reference(y, yx, hxe, hte, gamma: float, visc, quad: int,
                               want_entropy: bool = False):
    """((r1, r2, r3), ent) of the Euler system from the net at the edge
    points: ``y`` and ``yx`` (None when inviscid) (N * 4Q, 3), the
    half-widths (N, 1), ``visc`` the effective viscosity."""
    q = quad
    n = hxe.shape[0]
    y = y.reshape(n, 4 * q, 3)
    y_x = None if yx is None else yx.reshape(n, 4 * q, 3)
    cons, flux, eta, etaflux = euler_conserved_flux(y, gamma)
    if y_x is not None:
        rho, u = y[..., 0:1], y[..., 1:2]
        rho_x, u_x, e_x = y_x[..., 0:1], y_x[..., 1:2], y_x[..., 2:3]
        cons_x = torch.cat([rho_x, rho_x * u + rho * u_x, e_x], dim=-1)
        flux = flux - visc * cons_x
    w = _consts(gauss_legendre(q)[1], y)
    measure = 4.0 * hxe * hte
    d_cons = cons[:, q:2 * q] - cons[:, 0:q]
    d_flux = flux[:, 3 * q:4 * q] - flux[:, 2 * q:3 * q]
    r = (hxe * quad_sum(d_cons, w) + hte * quad_sum(d_flux, w)) / measure
    ent = None
    if want_entropy:
        d_eta = eta[:, q:2 * q] - eta[:, 0:q]
        d_ef = etaflux[:, 3 * q:4 * q] - etaflux[:, 2 * q:3 * q]
        if y_x is not None:
            # the viscous entropy flux -visc eta_x on the side edges
            eta_x = euler_entropy_x(y, y_x, gamma)
            d_ef = d_ef - visc * (eta_x[:, 3 * q:4 * q] - eta_x[:, 2 * q:3 * q])
        e = (hxe * quad_sum(d_eta, w) + hte * quad_sum(d_ef, w)) / measure
        ent = torch.clamp(e, min=0.0) ** 2
    return (r[:, 0:1], r[:, 1:2], r[:, 2:3]), ent


def _coeffs(values, like: torch.Tensor) -> torch.Tensor:
    """The kernel's coefficient vector on ``like``'s device and dtype, from
    tensors (kept in the autograd graph) or Python floats."""
    return torch.cat([v.reshape(1).to(like.dtype) if isinstance(v, torch.Tensor)
                      else torch.full((1,), float(v), dtype=like.dtype, device=like.device)
                      for v in values])


def _on_card(centers: torch.Tensor, plain: bool) -> bool:
    """Whether the kernels take this call."""
    return not (plain or centers.device.type == "cpu")


def _edge_values(spec: MLPSpec, params: Params, pts: torch.Tensor, viscous: bool,
                 plain: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The net at the edge points: (y, y_x) from the Taylor-1 streams when
    viscous, else (y, None) from the forward pass."""
    if viscous:
        y, y_x, _ = (mlp_taylor_1_reference if plain else mlp_taylor_1)(spec, params, pts)
        return y, y_x
    return (mlp_apply_reference if plain else mlp_apply)(spec, params, pts), None


def burgers_flux_residual(spec: MLPSpec, params: Params, centers: torch.Tensor, lambda1,
                          lambda2, hx: float, ht: float, quad: int = 4,
                          want_entropy: bool = False, viscous: bool = True,
                          plain: bool = False):
    """Cell-mean conservation residual of Burgers at the cell centers (N, 2):
    (r, ent), each (N, 1), ent None unless asked for. ``viscous`` is the
    static flag of the JAX package (the lambda2 term and its derivative
    pass); ``lambda1`` / ``lambda2`` are tensors on the centers' device."""
    if not _on_card(centers, plain):
        pts, hxe, hte = edge_points_reference(spec, centers, hx, ht, quad)
        u, ux = _edge_values(spec, params, pts, viscous, plain=True)
        return burgers_quadrature_reference(u, ux, hxe, hte, lambda1, lambda2, quad,
                                            want_entropy)
    from pinns_tpu_torch.ops.kernels import weakform as k7b

    pts, hxe, hte = k7b.edge_points(spec, centers, hx, ht, quad)
    u, ux = _edge_values(spec, params, pts, viscous, plain=False)
    coeffs = _coeffs((lambda1, lambda2), u)
    if want_entropy:
        return k7b.flux_quadrature("burgers", u, ux, hxe, hte, coeffs, quad, entropy=True)
    return k7b.flux_quadrature("burgers", u, ux, hxe, hte, coeffs, quad), None


def euler_flux_residuals(spec: MLPSpec, params: Params, centers: torch.Tensor, gamma: float,
                         hx: float, ht: float, quad: int = 4, want_entropy: bool = False,
                         visc=0.0, viscous: bool = False, plain: bool = False):
    """Cell-mean conservation residuals of the Euler system (mass, momentum,
    energy) at the cell centers (N, 2): ((r1, r2, r3), ent), each (N, 1).
    ``visc`` (a tensor on the centers' device when ``viscous``) is the
    artificial viscosity on the conserved variables."""
    if not _on_card(centers, plain):
        pts, hxe, hte = edge_points_reference(spec, centers, hx, ht, quad)
        y, yx = _edge_values(spec, params, pts, viscous, plain=True)
        return euler_quadrature_reference(y, yx, hxe, hte, gamma, visc, quad, want_entropy)
    from pinns_tpu_torch.ops.kernels import weakform as k7b

    pts, hxe, hte = k7b.edge_points(spec, centers, hx, ht, quad)
    y, yx = _edge_values(spec, params, pts, viscous, plain=False)
    # (gamma - 1, visc): gamma - 1 rounded from the float64 difference, as the
    # plain version's (gamma - 1.0) * (...) rounds it
    coeffs = _coeffs((gamma - 1.0, visc), y)
    ent = None
    if want_entropy:
        r, ent = k7b.flux_quadrature("euler", y, yx, hxe, hte, coeffs, quad, entropy=True,
                                     gamma=gamma)
    else:
        r = k7b.flux_quadrature("euler", y, yx, hxe, hte, coeffs, quad)
    return (r[:, 0:1], r[:, 1:2], r[:, 2:3]), ent
