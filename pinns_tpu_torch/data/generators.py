"""Native ground truth of the Euler dataset (the port's own copy of three
numpy functions of ``pinns_tpu/data/generators.py``: ``euler_exact_riemann``,
``blend_primitives`` and ``make_abgrall_eulers_grid``).

The ``abgrall_eulers`` dataset is one shock-tube Riemann problem (the
reference's Sod/Lax mu-blend initial condition, ``EulerDriver1D.m:17-32``)
whose waves never reach the boundaries before its final time, so its exact
solution exists in closed form on the whole grid: a Newton solve for the star
pressure, then self-similar sampling in xi = (x - x0) / t (Toro, ch. 4). It
is plain float64 numpy, as in the JAX package, and agrees with it to
rounding. The port grades Euler models against this grid, as the JAX package
does when the reference ``.mat`` is absent: the stored DG grid departs from it
by up to 28% in u.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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
