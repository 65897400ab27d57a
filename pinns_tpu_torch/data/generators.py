"""Native ground-truth data generation (port of ``pinns_tpu/data/generators.py``).

The reference generates its datasets offline with MATLAB codes; the JAX
package regenerates every known grid itself, and so does the port, with its
own copy of each generator:

- float64 numpy oracles, copied: :func:`burgers_cole_hopf` (the viscous
  Burgers solution by the Cole-Hopf transform and Gauss-Hermite quadrature,
  the ``burgers_shock`` grid), :func:`euler_solve_hllc` (MUSCL on primitives
  + HLLC), :func:`burgers_weno` (WENO5), the exact Riemann solution of the
  ``abgrall_eulers`` grid (:func:`euler_exact_riemann`), and the identified
  initial conditions and clocks of the TwoSin and Abgrall grids;
- the float32 finite-volume solvers :func:`euler_solve` (MUSCL minmod, local
  Lax-Friedrichs, SSP-RK3 at a fixed CFL step, the Sod-Lax mu-blend shock
  tube) and :func:`burgers_fv` (the same machinery with the Godunov flux,
  central viscosity, outflow or periodic ghosts and ``t_offset`` pre-steps).
  JAX runs them as ``lax.scan`` programs on the accelerator. Here the time
  loop is ``ops.kernels.fv_solve``: K12, one CUDA launch a whole solve, when
  ``device`` is the card, and the plain PyTorch scheme below
  (:func:`burgers_rhs`, :func:`euler_rhs`, :func:`rk3`) on the CPU, in
  float32 as JAX or in float64;
- :func:`make_twosin_grid` and :func:`make_abgrall_burgers_grid` over
  :func:`burgers_fv`, resampled by ``np.interp`` in float64 as in JAX;
- :func:`save_mat`, the ``{x, t, usol[...]}`` ``.mat`` schema the loaders
  read.

The float32 grids follow JAX's arithmetic op by op but not bit for bit: the
grid's float32 points come from one formula here (:func:`linspace32`) and
XLA's CPU arithmetic is not ATen's. The tests hold them to JAX's by the
float64 criterion (their difference within a few times the float32 error of
either against the port's float64 run) with equal step counts.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# Cole-Hopf closed form (viscous Burgers, the burgers_shock grid)
# --------------------------------------------------------------------------
def burgers_cole_hopf(
    x: np.ndarray,
    t: np.ndarray,
    nu: float = 0.01 / np.pi,
    n_quad: int = 128,
) -> np.ndarray:
    """u(x, t) solving u_t + u u_x = nu u_xx, u(x,0) = -sin(pi x), as the
    (Nx, Nt) ``usol`` layout, float64: u = -2 nu d/dx log theta, theta's
    integral in Gauss-Hermite form with a = sqrt(4 nu t),
    u(x,t) = int sin(pi(x - a z)) w(z) G(z) dz / int w(z) G(z) dz,
    G(z) = exp(-cos(pi (x - a z)) / (2 pi nu))."""
    x = np.asarray(x, np.float64).ravel()
    t = np.asarray(t, np.float64).ravel()
    z, w = np.polynomial.hermite.hermgauss(n_quad)

    usol = np.empty((x.size, t.size))
    for j, tj in enumerate(t):
        if tj <= 0.0:
            usol[:, j] = -np.sin(np.pi * x)
            continue
        a = np.sqrt(4.0 * nu * tj)
        eta = x[:, None] - a * z[None, :]  # (Nx, Q)
        g = np.exp(-np.cos(np.pi * eta) / (2.0 * np.pi * nu))
        num = np.sum(w[None, :] * np.sin(np.pi * eta) * g, axis=1)
        den = np.sum(w[None, :] * g, axis=1)
        usol[:, j] = -num / den
    return usol


def make_burgers_shock_grid(
    nx: int = 256, nt: int = 100, nu: float = 0.01 / np.pi
) -> Dict[str, np.ndarray]:
    """{x, t, usol} with the canonical burgers_shock.mat layout and shapes."""
    x = np.linspace(-1.0, 1.0, nx).reshape(-1, 1)
    t = np.linspace(0.0, 0.99, nt).reshape(-1, 1)
    return {"x": x, "t": t, "usol": burgers_cole_hopf(x, t, nu)}


# --------------------------------------------------------------------------
# The finite-volume scheme (plain PyTorch; K12's plain version)
# --------------------------------------------------------------------------
def linspace32(a: float, b: float, n: int) -> np.ndarray:
    """n float32 points from a to b by JAX's formula for ``jnp.linspace``:
    a (1 - s) + b s with s = i / (n - 1) in float32, and b itself last."""
    f = np.float32
    s = np.arange(n - 1, dtype=f) / f(n - 1)
    return np.concatenate([f(a) * (f(1) - s) + f(b) * s, [f(b)]]).astype(f)


def _minmod(a, b):
    s = 0.5 * (torch.sign(a) + torch.sign(b))
    return s * torch.minimum(torch.abs(a), torch.abs(b))


def _muscl_faces(q):
    """Minmod-limited linear reconstruction: the (left, right) states at the
    Nx+1 faces with outflow ghost cells. q: (Nx, C)."""
    qp = torch.cat([q[:1], q, q[-1:]], dim=0)  # ghost cells
    dq = _minmod(qp[1:-1] - qp[:-2], qp[2:] - qp[1:-1])  # (Nx, C)
    q_left_face = q + 0.5 * dq  # right edge of each cell
    q_right_face = q - 0.5 * dq  # left edge of each cell
    ql = torch.cat([q[:1], q_left_face], dim=0)  # (Nx+1, C)
    qr = torch.cat([q_right_face, q[-1:]], dim=0)
    return ql, qr


def _euler_flux(q, gamma):
    rho, mom, e = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    u = mom / rho
    p = (gamma - 1.0) * (e - 0.5 * mom * u)
    return torch.cat([mom, mom * u + p, u * (e + p)], dim=1)


def _euler_max_speed(q, gamma):
    rho, mom, e = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    u = mom / rho
    p = (gamma - 1.0) * (e - 0.5 * mom * u)
    c = torch.sqrt(torch.clamp(gamma * p / rho, min=1e-12))
    return torch.abs(u) + c


def euler_ic_sod_lax_blend(x: torch.Tensor, mu: float = 0.3, gamma: float = 1.4):
    """The reference's initial condition, a mu-blend of the Sod and Lax shock
    tubes with the jump at x = 0.5 (``EulerDriver1D.m:17-32``), as the
    conservative state (Nx, 3) [rho, rho u, E] in x's dtype and device.

    Sod:  (rho, u, p) = (1, 0, 1) | (0.125, 0, 0.1)
    Lax:  (rho, u, p) = (0.445, 0.698, 3.528) | (0.5, 0, 0.571)
    """
    kw = {"dtype": x.dtype, "device": x.device}
    left_sod = torch.tensor([1.0, 0.0, 1.0], **kw)
    right_sod = torch.tensor([0.125, 0.0, 0.1], **kw)
    left_lax = torch.tensor([0.445, 0.698, 3.528], **kw)
    right_lax = torch.tensor([0.5, 0.0, 0.571], **kw)
    left = mu * left_lax + (1.0 - mu) * left_sod
    right = mu * right_lax + (1.0 - mu) * right_sod
    prim = torch.where(x.reshape(-1, 1) < 0.5, left, right)
    rho, u, p = prim[:, 0:1], prim[:, 1:2], prim[:, 2:3]
    e = p / (gamma - 1.0) + 0.5 * rho * u * u
    return torch.cat([rho, rho * u, e], dim=1)


def euler_rhs(q, dx: float, gamma: float):
    """-(F_{i+1/2} - F_{i-1/2}) / dx of the Euler state q (Nx, 3): MUSCL
    faces, local Lax-Friedrichs flux, outflow ghosts."""
    ql, qr = _muscl_faces(q)
    a = torch.maximum(_euler_max_speed(ql, gamma), _euler_max_speed(qr, gamma))
    flux = 0.5 * (_euler_flux(ql, gamma) + _euler_flux(qr, gamma)) - 0.5 * a * (qr - ql)
    return -(flux[1:] - flux[:-1]) / dx


def _godunov_flux(ul, ur):
    # exact Riemann flux for f(u) = u^2/2
    f = lambda u: 0.5 * u * u  # noqa: E731
    shock = torch.where(0.5 * (ul + ur) > 0, f(ul), f(ur))
    raref = torch.where(ul > 0, f(ul), torch.where(ur < 0, f(ur), 0.0))
    return torch.where(ul > ur, shock, raref)


def burgers_rhs(u, dx: float, nu: float, periodic: bool):
    """The Burgers right-hand side of the state u (Nx,): MUSCL minmod faces,
    the Godunov flux, and nu times the central Laplacian when nu > 0; outflow
    or periodic ghosts (periodic: face i between cells i-1 and i, wrapped)."""
    if periodic:
        up = torch.cat([u[-1:], u, u[:1]])
    else:
        up = torch.cat([u[:1], u, u[-1:]])
    du = _minmod(up[1:-1] - up[:-2], up[2:] - up[1:-1])
    if periodic:
        ul = torch.roll(u + 0.5 * du, 1)
        ur = u - 0.5 * du
        flux = _godunov_flux(ul, ur)
        adv = -(torch.roll(flux, -1) - flux) / dx
    else:
        ul = torch.cat([u[:1], u + 0.5 * du])
        ur = torch.cat([u - 0.5 * du, u[-1:]])
        flux = _godunov_flux(ul, ur)
        adv = -(flux[1:] - flux[:-1]) / dx
    if nu > 0:
        lap = (up[2:] - 2 * up[1:-1] + up[:-2]) / (dx * dx)
        return adv + nu * lap
    return adv


def rk3(q, dt: float, rhs: Callable):
    """One SSP-RK3 step of q' = rhs(q)."""
    q1 = q + dt * rhs(q)
    q2 = 0.75 * q + 0.25 * (q1 + dt * rhs(q1))
    return q / 3.0 + 2.0 / 3.0 * (q2 + dt * rhs(q2))


def fv_trajectory_reference(q0: torch.Tensor, rhs: Callable, dt: float, steps_per_snap: int,
                            n_snap: int, offset_steps: int = 0) -> torch.Tensor:
    """The plain time loop: ``offset_steps`` RK3 steps, then ``n_snap``
    snapshots ``steps_per_snap`` steps apart, the first the state after the
    pre-steps: (n_snap, *q0.shape), on q0's device and dtype."""
    q = q0
    for _ in range(offset_steps):
        q = rk3(q, dt, rhs)
    traj = torch.empty((n_snap, *q0.shape), dtype=q0.dtype, device=q0.device)
    traj[0] = q
    for k in range(1, n_snap):
        for _ in range(steps_per_snap):
            q = rk3(q, dt, rhs)
        traj[k] = q
    return traj


# --------------------------------------------------------------------------
# The float32 FV solvers (K12 on the card)
# --------------------------------------------------------------------------
def _resolve(device) -> torch.device:
    from pinns_tpu_torch.device import resolve_device

    return resolve_device(device)


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the FV solvers run float32 or float64, not {dtype}")


class FVPlan(NamedTuple):
    """A solve's inputs as the host fixes them before the time loop."""

    x: np.ndarray  # the grid points (Burgers) or cell centres (Euler)
    q0: torch.Tensor  # the initial state on the device: (n,) or (n, 3)
    dx: float
    dt: float
    steps_per_snap: int
    n_snap: int
    offset_steps: int = 0


def euler_plan(nx: int = 1500, t_final: float = 0.2, gamma: float = 1.4, cfl: float = 0.4,
               xlim: Tuple[float, float] = (0.0, 1.0), ic: Optional[Callable] = None,
               n_snapshots: int = 160, device="cuda",
               dtype: torch.dtype = torch.float32) -> FVPlan:
    """:func:`euler_solve`'s cell centres, initial state and fixed step: dt
    from the initial wave speeds with a 1.5 margin, rounded so that the
    snapshots land on uniform times."""
    _check_dtype(dtype)
    dev = _resolve(device)
    if dtype == torch.float32:
        x = linspace32(xlim[0], xlim[1], nx + 1)
        xc = (np.float32(0.5) * (x[:-1] + x[1:])).astype(np.float32)  # cell centres
    else:
        x = np.linspace(xlim[0], xlim[1], nx + 1)
        xc = 0.5 * (x[:-1] + x[1:])
    dx = float((xlim[1] - xlim[0]) / nx)
    xt = torch.as_tensor(xc, dtype=dtype).to(dev)
    q0 = euler_ic_sod_lax_blend(xt, gamma=gamma) if ic is None else ic(xt)
    smax = float(torch.max(_euler_max_speed(q0, gamma)))
    dt = cfl * dx / (smax * 1.5)  # margin for transient wave acceleration
    steps_per_snap = max(1, int(np.ceil(t_final / (n_snapshots - 1) / dt)))
    dt = t_final / (n_snapshots - 1) / steps_per_snap
    return FVPlan(xc, q0, dx, dt, steps_per_snap, n_snapshots)


def euler_solve(
    nx: int = 1500,
    t_final: float = 0.2,
    gamma: float = 1.4,
    cfl: float = 0.4,
    xlim: Tuple[float, float] = (0.0, 1.0),
    ic: Optional[Callable] = None,
    n_snapshots: int = 160,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """1D Euler shock-tube solve: {x, t, rhosol, usol, Enersol} with the
    (Nx, Nt) field layout of ``Abgrall_eulers.mat``.

    MUSCL(minmod) + local Lax-Friedrichs + SSP-RK3 at the fixed step of
    :func:`euler_plan`. ``ic`` maps the cell centres (a tensor) to the
    conservative state (Nx, 3); the default is the Sod-Lax blend. The time
    loop is K12 on a CUDA ``device`` (float32) and the plain scheme on the
    CPU."""
    from pinns_tpu_torch.ops.kernels import fv_solve

    plan = euler_plan(nx, t_final, gamma, cfl, xlim, ic, n_snapshots, device, dtype)
    traj = fv_solve.euler_trajectory(plan.q0, plan.dx, plan.dt, plan.steps_per_snap,
                                     plan.n_snap, gamma).cpu().numpy()  # (Nt, Nx, 3)
    rho = traj[:, :, 0].T  # (Nx, Nt)
    mom = traj[:, :, 1].T
    ener = traj[:, :, 2].T
    return {
        "x": np.asarray(plan.x).reshape(-1, 1),
        "t": np.linspace(0.0, t_final, n_snapshots).reshape(-1, 1),
        "rhosol": rho,
        "usol": mom / rho,  # velocity, as the reference stores it
        "Enersol": ener,
    }


def burgers_plan(ic: Callable[[np.ndarray], np.ndarray], nx: int = 512, nt: int = 101,
                 t_final: float = 1.0, nu: float = 0.0,
                 xlim: Tuple[float, float] = (-1.0, 1.0), cfl: float = 0.4,
                 periodic: bool = False, t_offset: float = 0.0, device="cuda",
                 dtype: torch.dtype = torch.float32) -> FVPlan:
    """:func:`burgers_fv`'s grid, initial state (the evolved cells: all but
    the last point when ``periodic``) and fixed step: the advective CFL step
    with a 1.6 margin, the viscous limit when nu > 0, rounded so that the
    snapshots land on uniform times; ``t_offset`` in whole steps."""
    _check_dtype(dtype)
    dev = _resolve(device)
    if dtype == torch.float32:
        x = linspace32(xlim[0], xlim[1], nx)
    else:
        x = np.linspace(xlim[0], xlim[1], nx)
    dx = float(x[1] - x[0])
    u0 = torch.as_tensor(np.asarray(ic(x)), dtype=dtype).reshape(-1).to(dev)
    if periodic:
        u0 = u0[:-1]  # the duplicated right endpoint is re-appended to the snapshots
    smax = float(torch.max(torch.abs(u0))) + 1e-6
    dt = cfl * dx / (smax * 1.6)
    if nu > 0:
        dt = min(dt, 0.4 * dx * dx / (2 * nu))
    steps_per_snap = max(1, int(np.ceil(t_final / (nt - 1) / dt)))
    dt = t_final / (nt - 1) / steps_per_snap
    offset_steps = max(0, int(round(t_offset / dt)))
    return FVPlan(x, u0, dx, dt, steps_per_snap, nt, offset_steps)


def burgers_fv(
    ic: Callable[[np.ndarray], np.ndarray],
    nx: int = 512,
    nt: int = 101,
    t_final: float = 1.0,
    nu: float = 0.0,
    xlim: Tuple[float, float] = (-1.0, 1.0),
    cfl: float = 0.4,
    periodic: bool = False,
    t_offset: float = 0.0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Scalar (in)viscid Burgers solve: Godunov flux + central viscous term,
    SSP-RK3 at the fixed step of :func:`burgers_plan`. Returns {x, t,
    usol:(Nx, Nt)}. ``periodic`` puts periodic ghost cells in place of the
    outflow ones (x[0] and x[-1] are the same physical point);
    ``t_offset`` evolves the IC by that much time before the first snapshot
    (the snapshots still labelled from 0). ``ic`` maps the numpy points to
    the initial values. The time loop is K12 on a CUDA ``device`` (float32)
    and the plain scheme on the CPU."""
    from pinns_tpu_torch.ops.kernels import fv_solve

    plan = burgers_plan(ic, nx, nt, t_final, nu, xlim, cfl, periodic, t_offset, device, dtype)
    traj = fv_solve.burgers_trajectory(plan.q0, plan.dx, plan.dt, plan.steps_per_snap,
                                       plan.n_snap, nu, periodic, plan.offset_steps)
    if periodic:  # re-append the duplicated right endpoint column
        traj = torch.cat([traj, traj[:, :1]], dim=1)
    return {
        "x": np.asarray(plan.x).reshape(-1, 1),
        "t": np.linspace(0.0, t_final, nt).reshape(-1, 1),
        "usol": traj.cpu().numpy().T,
    }


# The identified snapshot clock of Abgrall_eulers.mat (the JAX package's fit
# of the exact solution to the stored DG grid): column k is at
# EULER_T0 + k EULER_DT.
EULER_T0 = 0.002032
EULER_DT = 0.0012743


def euler_exact_riemann(
    x: np.ndarray,
    t: float,
    left: Tuple[float, float, float],
    right: Tuple[float, float, float],
    gamma: float = 1.4,
    x0: float = 0.5,
) -> np.ndarray:
    """Exact solution of the 1D Euler Riemann problem at time t: primitives
    (rho, u, p), (N, 3) float64, at the points x, from the left/right
    primitive states (rho, u, p) separated at x0."""
    rl, ul, pl = (float(v) for v in left)
    rr, ur, pr = (float(v) for v in right)
    cl = np.sqrt(gamma * pl / rl)
    cr = np.sqrt(gamma * pr / rr)
    gm1, gp1 = gamma - 1.0, gamma + 1.0

    def f_and_df(p, rk, pk, ck):
        if p > pk:  # shock branch
            a, b = 2.0 / (gp1 * rk), gm1 / gp1 * pk
            s = np.sqrt(a / (p + b))
            return (p - pk) * s, s * (1.0 - 0.5 * (p - pk) / (p + b))
        # rarefaction branch (Toro eq. 4.7)
        pr_ = (p / pk) ** (gm1 / (2.0 * gamma))
        return (
            2.0 * ck / gm1 * (pr_ - 1.0),
            (p / pk) ** (-gp1 / (2.0 * gamma)) / (rk * ck),
        )

    def g_of(p):
        fl, dfl = f_and_df(p, rl, pl, cl)
        fr, dfr = f_and_df(p, rr, pr, cr)
        return fl + fr + du, dfl + dfr

    # Newton for p* from the two-rarefaction guess, kept positive
    du = ur - ul
    p_tr = (
        (cl + cr - 0.5 * gm1 * du)
        / (cl / pl ** (gm1 / (2 * gamma)) + cr / pr ** (gm1 / (2 * gamma)))
    ) ** (2.0 * gamma / gm1)
    p = max(1e-10, p_tr)
    converged = False
    for _ in range(60):
        g, dg = g_of(p)
        p_new = max(1e-12, p - g / dg)
        if abs(p_new - p) < 1e-14 * max(1.0, p):
            p = p_new
            converged = True
            break
        p = p_new
    if not converged:
        # g is strictly increasing, so bisection always converges
        lo, hi = 1e-12, max(p, pl, pr)
        while g_of(hi)[0] < 0.0:
            hi *= 2.0
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if g_of(mid)[0] < 0.0:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-15 * max(1.0, hi):
                break
        p = 0.5 * (lo + hi)
    pstar = p
    fl, _ = f_and_df(pstar, rl, pl, cl)
    fr, _ = f_and_df(pstar, rr, pr, cr)
    ustar = 0.5 * (ul + ur) + 0.5 * (fr - fl)

    xi = (np.asarray(x, np.float64) - x0) / max(float(t), 1e-300)
    rho = np.empty_like(xi)
    u = np.empty_like(xi)
    pp = np.empty_like(xi)

    # left of the contact
    L = xi < ustar
    if pstar > pl:  # left shock
        sl = ul - cl * np.sqrt(gp1 / (2 * gamma) * pstar / pl + gm1 / (2 * gamma))
        pre = L & (xi < sl)
        post = L & ~pre
        rstar = rl * ((pstar / pl + gm1 / gp1) / (gm1 / gp1 * pstar / pl + 1.0))
        rho[pre], u[pre], pp[pre] = rl, ul, pl
        rho[post], u[post], pp[post] = rstar, ustar, pstar
    else:  # left rarefaction
        cstar = cl * (pstar / pl) ** (gm1 / (2 * gamma))
        head, tail = ul - cl, ustar - cstar
        pre = L & (xi < head)
        fan = L & (xi >= head) & (xi <= tail)
        post = L & (xi > tail)
        rho[pre], u[pre], pp[pre] = rl, ul, pl
        cf = 2.0 / gp1 * (cl + 0.5 * gm1 * (ul - xi[fan]))
        u[fan] = 2.0 / gp1 * (cl + 0.5 * gm1 * ul + xi[fan])
        rho[fan] = rl * (cf / cl) ** (2.0 / gm1)
        pp[fan] = pl * (cf / cl) ** (2.0 * gamma / gm1)
        rho[post] = rl * (pstar / pl) ** (1.0 / gamma)
        u[post], pp[post] = ustar, pstar
    # right of the contact (mirror)
    R = ~L
    if pstar > pr:  # right shock
        sr = ur + cr * np.sqrt(gp1 / (2 * gamma) * pstar / pr + gm1 / (2 * gamma))
        post = R & (xi > sr)
        star = R & ~post
        rstar = rr * ((pstar / pr + gm1 / gp1) / (gm1 / gp1 * pstar / pr + 1.0))
        rho[post], u[post], pp[post] = rr, ur, pr
        rho[star], u[star], pp[star] = rstar, ustar, pstar
    else:  # right rarefaction
        cstar = cr * (pstar / pr) ** (gm1 / (2 * gamma))
        head, tail = ur + cr, ustar + cstar
        post = R & (xi > head)
        fan = R & (xi <= head) & (xi >= tail)
        star = R & (xi < tail)
        rho[post], u[post], pp[post] = rr, ur, pr
        cf = 2.0 / gp1 * (cr - 0.5 * gm1 * (ur - xi[fan]))
        u[fan] = 2.0 / gp1 * (-cr + 0.5 * gm1 * ur + xi[fan])
        rho[fan] = rr * (cf / cr) ** (2.0 / gm1)
        pp[fan] = pr * (cf / cr) ** (2.0 * gamma / gm1)
        rho[star] = rr * (pstar / pr) ** (1.0 / gamma)
        u[star], pp[star] = ustar, pstar
    return np.stack([rho, u, pp], axis=1)


def blend_primitives(mu: float = 0.3) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Left/right primitive states (rho, u, p) of the reference's Sod-Lax
    mu-blend initial condition (``EulerDriver1D.m:17-32``)."""
    left = (
        mu * 0.445 + (1 - mu) * 1.0,
        mu * 0.698,
        mu * 3.528 + (1 - mu) * 1.0,
    )
    right = (
        mu * 0.5 + (1 - mu) * 0.125,
        0.0,
        mu * 0.571 + (1 - mu) * 0.1,
    )
    return left, right


def make_abgrall_eulers_grid(
    nx: int = 300, nt: int = 157, gamma: float = 1.4
) -> Dict[str, np.ndarray]:
    """The ``abgrall_eulers`` grid from the exact Riemann solution: ``x``
    (nx, 1) uniform on [0, 1], ``t`` (nt, 1) at EULER_T0 + k EULER_DT, and
    ``rhosol`` / ``usol`` / ``Enersol`` (nx, nt) float64, the reference
    ``.mat``'s keys and layout."""
    left, right = blend_primitives()
    x = np.linspace(0.0, 1.0, nx)
    t = EULER_T0 + EULER_DT * np.arange(nt)
    rho = np.empty((nx, nt))
    u = np.empty((nx, nt))
    ener = np.empty((nx, nt))
    for k, tk in enumerate(t):
        w = euler_exact_riemann(x, float(tk), left, right, gamma=gamma)
        rho[:, k] = w[:, 0]
        u[:, k] = w[:, 1]
        ener[:, k] = w[:, 2] / (gamma - 1.0) + 0.5 * w[:, 0] * w[:, 1] ** 2
    return {
        "x": x.reshape(-1, 1),
        "t": t.reshape(-1, 1),
        "rhosol": rho,
        "usol": u,
        "Enersol": ener,
    }


# --------------------------------------------------------------------------
# Float64 Euler oracle (numpy): MUSCL on primitives + HLLC
# --------------------------------------------------------------------------
def _hllc_flux(ql, qr, gamma):
    """HLLC approximate Riemann flux for 1D Euler, conservative states
    (N, 3): far less dissipative at contacts than Lax-Friedrichs."""
    def split(q):
        rho = q[:, 0]
        u = q[:, 1] / rho
        e = q[:, 2]
        p = (gamma - 1.0) * (e - 0.5 * rho * u * u)
        p = np.maximum(p, 1e-12)
        return rho, u, e, p

    rl, ul, el, pl = split(ql)
    rr, ur, er, pr = split(qr)
    cl = np.sqrt(gamma * pl / rl)
    cr = np.sqrt(gamma * pr / rr)
    # Davis wave-speed estimates
    sl = np.minimum(ul - cl, ur - cr)
    sr = np.maximum(ul + cl, ur + cr)
    # contact speed (Toro 10.37)
    num = pr - pl + rl * ul * (sl - ul) - rr * ur * (sr - ur)
    den = rl * (sl - ul) - rr * (sr - ur)
    sm = num / np.where(np.abs(den) < 1e-14, 1e-14, den)

    def flux_of(rho, u, e, p):
        return np.stack([rho * u, rho * u * u + p, u * (e + p)], axis=1)

    fl = flux_of(rl, ul, el, pl)
    fr = flux_of(rr, ur, er, pr)

    def star(rho, u, e, p, s):
        coef = rho * (s - u) / (s - sm)
        q = np.empty((rho.size, 3))
        q[:, 0] = coef
        q[:, 1] = coef * sm
        q[:, 2] = coef * (e / rho + (sm - u) * (sm + p / (rho * (s - u))))
        return q

    qls = star(rl, ul, el, pl, sl)
    qrs = star(rr, ur, er, pr, sr)
    fls = fl + sl[:, None] * (qls - ql)
    frs = fr + sr[:, None] * (qrs - qr)
    return np.where((sl >= 0.0)[:, None], fl,
                    np.where((sm >= 0.0)[:, None], fls,
                             np.where((sr > 0.0)[:, None], frs, fr)))


def _minmod_np(a, b):
    s = 0.5 * (np.sign(a) + np.sign(b))
    return s * np.minimum(np.abs(a), np.abs(b))


def euler_solve_hllc(
    nx: int = 4000,
    t_final: float = 0.2,
    gamma: float = 1.4,
    cfl: float = 0.4,
    xlim: Tuple[float, float] = (0.0, 1.0),
    ic: Optional[Callable] = None,
    n_snapshots: int = 160,
) -> Dict[str, np.ndarray]:
    """1D Euler shock-tube solve in float64: MUSCL minmod on the primitive
    variables, HLLC flux, SSP-RK3, the CFL step re-evaluated every snapshot
    interval (1.5 headroom). The schema of :func:`euler_solve`.

    The default IC is the Sod-Lax blend evaluated in float32 and then
    widened, as the JAX package builds it (through ``jnp`` without x64):
    its states are the float32 blend's to the last digit."""
    x = np.linspace(xlim[0], xlim[1], nx + 1, dtype=np.float64)
    xc = 0.5 * (x[:-1] + x[1:])
    dx = float((xlim[1] - xlim[0]) / nx)
    if ic is None:
        xt = torch.as_tensor(xc, dtype=torch.float32)
        q0 = euler_ic_sod_lax_blend(xt, gamma=gamma).numpy().astype(np.float64)
    else:
        q0 = np.asarray(ic(xc), np.float64)

    def prim(q):
        rho = q[:, 0]
        u = q[:, 1] / rho
        p = (gamma - 1.0) * (q[:, 2] - 0.5 * rho * u * u)
        return np.stack([rho, u, np.maximum(p, 1e-12)], axis=1)

    def cons(w):
        rho, u, p = w[:, 0], w[:, 1], w[:, 2]
        return np.stack([rho, rho * u, p / (gamma - 1.0) + 0.5 * rho * u * u], axis=1)

    def rhs(q):
        w = prim(q)
        wp = np.concatenate([w[:1], w, w[-1:]], axis=0)  # outflow ghosts
        dw = _minmod_np(wp[1:-1] - wp[:-2], wp[2:] - wp[1:-1])
        w_r_edge = w + 0.5 * dw   # right edge of each cell
        w_l_edge = w - 0.5 * dw   # left edge of each cell
        wl = np.concatenate([w[:1], w_r_edge], axis=0)   # (nx+1, 3) faces
        wr = np.concatenate([w_l_edge, w[-1:]], axis=0)
        f = _hllc_flux(cons(wl), cons(wr), gamma)
        return -(f[1:] - f[:-1]) / dx

    def step(q, dt):
        q1 = q + dt * rhs(q)
        q2 = 0.75 * q + 0.25 * (q1 + dt * rhs(q1))
        return q / 3.0 + 2.0 / 3.0 * (q2 + dt * rhs(q2))

    t_snap = t_final / (n_snapshots - 1)
    traj = np.empty((n_snapshots, nx, 3))
    traj[0] = q0
    q = q0
    for k in range(1, n_snapshots):
        w = prim(q)
        smax = float(np.max(np.abs(w[:, 1]) + np.sqrt(gamma * w[:, 2] / w[:, 0])))
        steps = max(1, int(np.ceil(t_snap * smax * 1.5 / (cfl * dx))))
        dt = t_snap / steps
        for _ in range(steps):
            q = step(q, dt)
        if not np.all(np.isfinite(q)):
            raise FloatingPointError(
                f"euler_solve_hllc diverged in snapshot interval {k} "
                f"(smax={smax:.3g}, dt={dt:.3g}); refine nx or lower cfl"
            )
        traj[k] = q
    rho = traj[:, :, 0].T
    mom = traj[:, :, 1].T
    ener = traj[:, :, 2].T
    return {
        "x": xc.reshape(-1, 1),
        "t": np.linspace(0.0, t_final, n_snapshots).reshape(-1, 1),
        "rhosol": rho,
        "usol": mom / rho,
        "Enersol": ener,
    }


# --------------------------------------------------------------------------
# Float64 WENO5 Burgers oracle (numpy)
# --------------------------------------------------------------------------
def _weno5_left(fm2, fm1, f0, fp1, fp2, eps=1e-12):
    """Classic Jiang-Shu WENO5 left-biased reconstruction at i+1/2."""
    b0 = 13.0 / 12.0 * (fm2 - 2 * fm1 + f0) ** 2 + 0.25 * (fm2 - 4 * fm1 + 3 * f0) ** 2
    b1 = 13.0 / 12.0 * (fm1 - 2 * f0 + fp1) ** 2 + 0.25 * (fm1 - fp1) ** 2
    b2 = 13.0 / 12.0 * (f0 - 2 * fp1 + fp2) ** 2 + 0.25 * (3 * f0 - 4 * fp1 + fp2) ** 2
    a0 = 0.1 / (eps + b0) ** 2
    a1 = 0.6 / (eps + b1) ** 2
    a2 = 0.3 / (eps + b2) ** 2
    s = a0 + a1 + a2
    q0 = (2 * fm2 - 7 * fm1 + 11 * f0) / 6.0
    q1 = (-fm1 + 5 * f0 + 2 * fp1) / 6.0
    q2 = (2 * f0 + 5 * fp1 - fp2) / 6.0
    return (a0 * q0 + a1 * q1 + a2 * q2) / s


def burgers_weno(
    ic: Callable[[np.ndarray], np.ndarray],
    nx: int = 2048,
    nt: int = 101,
    t_final: float = 1.0,
    nu: float = 0.0,
    xlim: Tuple[float, float] = (-1.0, 1.0),
    cfl: float = 0.4,
    periodic: bool = True,
    t_offset: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Scalar Burgers solve in float64: WENO5 (Jiang-Shu) flux reconstruction
    with global Lax-Friedrichs splitting, central viscosity, SSP-RK3. The
    schema of :func:`burgers_fv`; with ``periodic`` the x[0] / x[-1] columns
    are the same physical point."""
    x = np.linspace(xlim[0], xlim[1], nx, dtype=np.float64)
    dx = float(x[1] - x[0])
    u = np.asarray(ic(x), np.float64).ravel()
    if periodic:
        u = u[:-1]  # evolve [0, nx-1); the duplicated endpoint is re-appended

    def pad(v, k=3):
        if periodic:
            return np.concatenate([v[-k:], v, v[:k]])
        return np.concatenate([np.repeat(v[:1], k), v, np.repeat(v[-1:], k)])

    def rhs(v):
        alpha = np.max(np.abs(v)) + 1e-12
        vp = pad(v)  # (n + 6,)
        f = 0.5 * vp * vp
        fp = 0.5 * (f + alpha * vp)  # right-going: left-biased reconstruction
        fm = 0.5 * (f - alpha * vp)  # left-going: right-biased (mirror)
        n = v.size
        # the flux at face i+1/2 for i = -1..n-1; cell i lives at vp[i+3]
        idx = np.arange(-1, n) + 3
        fpos = _weno5_left(fp[idx - 2], fp[idx - 1], fp[idx], fp[idx + 1], fp[idx + 2])
        fneg = _weno5_left(fm[idx + 3], fm[idx + 2], fm[idx + 1], fm[idx], fm[idx - 1])
        flux = fpos + fneg  # (n + 1,) faces -1/2 .. n-1/2
        out = -(flux[1:] - flux[:-1]) / dx
        if nu > 0.0:
            vpp = pad(v, 1)
            out = out + nu * (vpp[2:] - 2 * vpp[1:-1] + vpp[:-2]) / (dx * dx)
        return out

    smax = np.max(np.abs(u)) + 1e-6
    dt = cfl * dx / (smax * 1.6)
    if nu > 0.0:
        dt = min(dt, 0.4 * dx * dx / (2.0 * nu))
    steps_per_snap = max(1, int(np.ceil(t_final / (nt - 1) / dt)))
    dt = t_final / (nt - 1) / steps_per_snap

    def step(v):
        v1 = v + dt * rhs(v)
        v2 = 0.75 * v + 0.25 * (v1 + dt * rhs(v1))
        return v / 3.0 + 2.0 / 3.0 * (v2 + dt * rhs(v2))

    for _ in range(max(0, int(round(t_offset / dt)))):
        u = step(u)
    traj = np.empty((nt, u.size))
    traj[0] = u
    for k in range(1, nt):
        for _ in range(steps_per_snap):
            u = step(u)
        traj[k] = u
    if periodic:
        traj = np.concatenate([traj, traj[:, :1]], axis=1)
    return {
        "x": x.reshape(-1, 1),
        "t": np.linspace(0.0, t_final, nt).reshape(-1, 1),
        "usol": traj.T,
    }


# --------------------------------------------------------------------------
# The TwoSin and Abgrall Burgers grids (identified ICs and clocks)
# --------------------------------------------------------------------------
def two_sin_ic(x: np.ndarray) -> np.ndarray:
    """The TwoSin dataset's IC: two sine periods over [-1, 1] of amplitude
    ``TWOSIN_AMP``, identified against the stored grid (whose columns are the
    viscous evolution of this IC at the measured times ``TWOSIN_TAU``)."""
    return TWOSIN_AMP * np.sin(2.0 * np.pi * x)


# The measured physical times tau(k) of TwoSin_burgers_shock.mat's 101
# columns (labelled t = linspace(0, 1, 101)) under the viscous Godunov
# evolution of TWOSIN_AMP sin(2 pi x) at nu = TWOSIN_NU (the JAX package's
# identification).
TWOSIN_NU = 1.9e-3
TWOSIN_AMP = 1.005
TWOSIN_TAU = (
    0.01000, 0.01362, 0.01738, 0.02100, 0.02463, 0.02838, 0.03200, 0.03575,
    0.03938, 0.04300, 0.04675, 0.05038, 0.05412, 0.05775, 0.06137, 0.06513,
    0.06875, 0.07237, 0.07600, 0.07975, 0.08338, 0.08700, 0.09062, 0.09425,
    0.09800, 0.10163, 0.10525, 0.10887, 0.11250, 0.11613, 0.11975, 0.12337,
    0.12700, 0.13062, 0.13425, 0.13787, 0.14163, 0.14525, 0.14888, 0.15250,
    0.15625, 0.16000, 0.16375, 0.16750, 0.17137, 0.17525, 0.17938, 0.18350,
    0.18763, 0.19188, 0.19612, 0.20037, 0.20438, 0.20838, 0.21225, 0.21600,
    0.21975, 0.22338, 0.22712, 0.23075, 0.23450, 0.23813, 0.24188, 0.24563,
    0.24938, 0.25312, 0.25688, 0.26062, 0.26450, 0.26825, 0.27213, 0.27587,
    0.27975, 0.28363, 0.28750, 0.29137, 0.29525, 0.29925, 0.30313, 0.30712,
    0.31112, 0.31512, 0.31912, 0.32312, 0.32712, 0.33125, 0.33525, 0.33937,
    0.34350, 0.34763, 0.35187, 0.35600, 0.36025, 0.36450, 0.36875, 0.37300,
    0.37738, 0.38162, 0.38600, 0.39038, 0.39475,
)


def _twosin_taus(nt: int) -> np.ndarray:
    taus = np.asarray(TWOSIN_TAU)
    if nt != len(taus):  # the measured clock interpolated to other column counts
        taus = np.interp(np.linspace(0, 1, nt), np.linspace(0, 1, len(taus)), taus)
    return taus


def twosin_fv_args(nt: int = 101, nu: float = TWOSIN_NU, fv_nx: int = 2049) -> Dict:
    """:func:`burgers_fv`'s arguments (but the device and dtype) of
    :func:`make_twosin_grid`'s solve: :func:`two_sin_ic` on ``fv_nx`` points
    (periodic), snapshots every 2.5e-4 to 0.01 past the last measured time."""
    t_final = float(_twosin_taus(nt)[-1] + 0.01)
    return dict(ic=two_sin_ic, nx=fv_nx, nt=int(round(t_final / 2.5e-4)) + 1, t_final=t_final,
                nu=nu, xlim=(-1.0, 1.0), periodic=True)


def make_twosin_grid(
    nx: int = 513, nt: int = 101, nu: float = TWOSIN_NU, fv_nx: int = 2049, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """TwoSin_burgers_shock.mat regenerated (513 x 101, x in [-1, 1], labels
    t = linspace(0, 1, 101)): the :func:`burgers_fv` solve of
    :func:`twosin_fv_args`, the column nearest each measured time
    ``TWOSIN_TAU`` kept, then ``np.interp`` onto the grid. ``dtype`` is the
    solver's (float64: the tests' criterion)."""
    taus = _twosin_taus(nt)
    out = burgers_fv(**twosin_fv_args(nt, nu, fv_nx), device=device, dtype=dtype)
    snap_t = out["t"].ravel()
    cols = [out["usol"][:, int(np.argmin(np.abs(snap_t - tk)))] for tk in taus]
    u_dense = np.stack(cols, axis=1)  # (fv_nx, nt)
    x = np.linspace(-1.0, 1.0, nx)
    usol = np.stack(
        [np.interp(x, out["x"].ravel(), u_dense[:, k]) for k in range(len(taus))], axis=1
    )
    return {
        "x": x.reshape(-1, 1),
        "t": np.linspace(0.0, 1.0, nt).reshape(-1, 1),
        "usol": usol,
    }


# The Abgrall_burgers_shock.mat identification (the JAX package's): u_t +
# lam1 u u_x = nu u_xx in label time, the t = 0 column the IC evolved by tau0.
ABGRALL_LAM1 = 1.0078   # the stored clock runs ~0.8% fast against label time
ABGRALL_NU = 4.95e-3    # effective dissipation in label time
ABGRALL_TAU0 = 0.01196  # the t=0 column is the IC evolved by this much
ABGRALL_IC_A = 0.1018
ABGRALL_IC_B = 0.6490


def abgrall_burgers_ic(x: np.ndarray) -> np.ndarray:
    """The Abgrall_burgers_shock dataset's identified IC, periodic on
    [0, pi]: u0 = a + b |sin(2x)| with a = ``ABGRALL_IC_A``, b =
    ``ABGRALL_IC_B``."""
    return ABGRALL_IC_A + ABGRALL_IC_B * np.abs(np.sin(2.0 * x))


def abgrall_fv_args(nt: int = 257, nu: float = ABGRALL_NU, fv_nx: int = 1025) -> Dict:
    """:func:`burgers_fv`'s arguments (but the device and dtype) of
    :func:`make_abgrall_burgers_grid`'s solve: :func:`abgrall_burgers_ic` on
    ``fv_nx`` points (periodic) over [0, pi] with the identified clock,
    dissipation and offset."""
    lam1 = ABGRALL_LAM1
    return dict(ic=abgrall_burgers_ic, nx=fv_nx, nt=nt, t_final=float(lam1 * np.pi),
                nu=float(nu / lam1), xlim=(0.0, float(np.pi)), periodic=True,
                t_offset=float(lam1 * ABGRALL_TAU0))


def make_abgrall_burgers_grid(
    nx: int = 257, nt: int = 257, nu: float = ABGRALL_NU, fv_nx: int = 1025, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Abgrall_burgers_shock.mat regenerated (257 x 257 over [0, pi]^2): the
    :func:`burgers_fv` solve of :func:`abgrall_fv_args`, then ``np.interp``
    onto the grid. ``dtype`` is the solver's."""
    t_final = float(np.pi)
    out = burgers_fv(**abgrall_fv_args(nt, nu, fv_nx), device=device, dtype=dtype)
    x = np.linspace(0.0, float(np.pi), nx)
    usol = np.stack(
        [np.interp(x, out["x"].ravel(), out["usol"][:, k]) for k in range(nt)], axis=1
    )
    return {
        "x": x.reshape(-1, 1),
        "t": np.linspace(0.0, t_final, nt).reshape(-1, 1),
        "usol": usol,
    }


def save_mat(path: str, data: Dict[str, np.ndarray]) -> str:
    import scipy.io

    scipy.io.savemat(path, data)
    return path
