"""L-BFGS with a strong-Wolfe zoom line search (port of
``pinns_tpu/opt/lbfgs.py``).

The same algorithm, branch for branch: the two-loop recursion over a
circular (s, y) history with ``head`` and ``count``, the bracket + zoom
strong-Wolfe line search of Nocedal & Wright (alg. 3.5/3.6, bisection trial
points) with its evaluation budget and its best-sufficient-decrease
fallback, the descent guard, the first-step size min(1, 1/sum|g|), the
scaling gamma = s.y / y.y, and SciPy's stopping rules:
  - gradient:  max|g| <= gtol
  - function:  (f_k - f_{k+1}) / max(|f_k|, |f_{k+1}|, 1) <= ftol
  - iteration cap, or a failed line search.
``torch.optim.LBFGS`` is a different algorithm (line search and stops), so it
is not used.

Vectors are plain torch tensors on the caller's device, in its dtype. The
JAX package runs the whole solve as one ``lax.while_loop``; here the branch
decisions are taken on the host, in the working dtype (numpy scalars of it,
so a comparison rounds as the device would). Each read of device scalars is
one host sync, counted in ``HOST_SYNCS``: per iteration one for the
direction, one per line-search evaluation, and one for the curvature pair
and the stopping tests. The history's rho and gamma stay on the host.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

HOST_SYNCS = 0  # device -> host reads of L-BFGS scalars in this process


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor  # 0-d, on x's device
    g: torch.Tensor
    n_iters: int
    n_evals: int
    converged: bool  # a tolerance triggered (not the iteration cap or a failed search)


def _host(np_dtype, *scalars: torch.Tensor) -> List:
    """0-d tensors -> numpy scalars of ``np_dtype``, in one device -> host copy."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return [np_dtype(v) for v in torch.stack(scalars).cpu().numpy()]


def value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor]):
    """x -> (f(x) detached, df/dx) by torch.autograd."""

    def vg(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = fun(x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    return vg


def _zoom_linesearch(vg, x, f0, g0, d, dphi0, init_step, c1, c2, max_evals):
    """Strong-Wolfe line search along d from x, with ``f0``/``dphi0`` the
    host values of f and g.d at x. Returns (a, f, g, ok, evals): f a 0-d
    tensor, a and ok on the host."""
    T = type(f0)
    f0_t = torch.as_tensor(f0, dtype=x.dtype, device=x.device)
    a_max = T(1e8)
    c1, c2 = T(c1), T(c2)
    mode = 0  # 0 = bracket, 1 = zoom
    a_lo, phi_lo, dphi_lo = T(0), f0, dphi0
    a_hi, phi_hi = T(0), f0
    a_prev, phi_prev, dphi_prev = T(0), f0, dphi0
    a_trial = T(init_step)
    evals = 0
    a_best, f_best, f_best_t, g_best = T(0), f0, f0_t, g0
    while True:
        a = a_trial
        phi_t, g = vg(x + float(a) * d)
        phi, dphi = _host(T, phi_t, torch.dot(g, d))
        evals += 1
        out_of_budget = evals >= max_evals
        wolfe1 = phi <= f0 + c1 * a * dphi0
        wolfe2 = abs(dphi) <= -c2 * dphi0
        accept = wolfe1 and wolfe2
        if mode == 0:  # Nocedal & Wright alg. 3.5
            to_zoom_hi = (not wolfe1) or (phi >= phi_prev and evals > 1)  # zoom(a_prev, a)
            to_zoom_rev = (not to_zoom_hi) and dphi >= 0  # zoom(a, a_prev)
            if to_zoom_hi:
                a_lo, phi_lo, dphi_lo, a_hi, phi_hi = a_prev, phi_prev, dphi_prev, a, phi
            elif to_zoom_rev:
                a_lo, phi_lo, dphi_lo, a_hi, phi_hi = a, phi, dphi, a_prev, phi_prev
            if to_zoom_hi or to_zoom_rev:
                mode = 1
                a_trial = T(0.5) * (a_lo + a_hi)
            else:
                a_trial = min(T(2) * a, a_max)
            a_prev, phi_prev, dphi_prev = a, phi, dphi
        else:  # alg. 3.6 with bisection trial points
            cond_hi = (not wolfe1) or phi >= phi_lo
            swap = (not cond_hi) and dphi * (a_hi - a_lo) >= 0
            if cond_hi:
                a_hi, phi_hi = a, phi
            else:
                if swap:
                    a_hi, phi_hi = a_lo, phi_lo
                a_lo, phi_lo, dphi_lo = a, phi, dphi
            a_trial = T(0.5) * (a_lo + a_hi)
        interval_dead = mode == 1 and abs(a_hi - a_lo) <= T(1e-12) * max(T(1), abs(a_hi))
        fail = (not accept) and (out_of_budget or interval_dead)
        if (wolfe1 and phi < f_best) or accept:  # best sufficient decrease, as a fallback
            a_best, f_best, f_best_t, g_best = a, phi, phi_t, g
        if accept or fail:
            return a_best, f_best_t, g_best, accept or f_best < f0, evals


def _two_loop_direction(g, s_hist, y_hist, rho_hist, count, head, gamma):
    """Two-loop recursion over the circular history (m, n) of which the
    ``count`` newest pairs, ending before ``head``, are valid."""
    m = s_hist.shape[0]
    q = g
    alphas = [None] * m
    for j in range(count):
        idx = (head - 1 - j) % m
        alphas[idx] = float(rho_hist[idx]) * torch.dot(s_hist[idx], q)
        q = q - alphas[idx] * y_hist[idx]
    r = float(gamma) * q
    for j in range(count):
        idx = (head - count + j) % m
        beta = float(rho_hist[idx]) * torch.dot(y_hist[idx], r)
        r = r + (alphas[idx] - beta) * s_hist[idx]
    return -r


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iters: int = 5000,
    history: int = 50,
    ftol: float = 1e-7,
    gtol: float = 1e-5,
    max_ls: int = 50,
    c1: float = 1e-4,
    c2: float = 0.9,
) -> LBFGSResult:
    """Minimize ``fun`` (a flat tensor -> 0-d tensor, differentiable by
    torch.autograd) from the flat ``x0``, on ``x0``'s device and dtype."""
    vg = value_and_grad(fun)
    T = np.float64 if x0.dtype == torch.float64 else np.float32
    n, m = x0.shape[0], history
    x = x0.detach()
    f, g = vg(x)
    s_hist = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    y_hist = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    rho_hist = [T(0)] * m
    count = head = k = 0
    gamma = T(1)
    evals = 1
    f_h, gmax = _host(T, f, g.abs().max())
    converged = stop = bool(gmax <= T(gtol))  # an already-converged start
    while not stop:
        d = _two_loop_direction(g, s_hist, y_hist, rho_hist, count, head, gamma)
        dg, gsum = _host(T, torch.dot(d, g), g.abs().sum())
        if not dg < 0:  # guard against non-descent directions: steepest descent
            d = -g
            (dg,) = _host(T, torch.dot(g, d))
        init_step = min(T(1), T(1) / max(gsum, T(1e-12))) if count == 0 else T(1)

        a, f_new, g_new, ok, ls_evals = _zoom_linesearch(
            vg, x, f_h, g, d, dg, init_step, c1, c2, max_ls)
        x_new = x + float(a) * d
        s_vec = x_new - x
        y_vec = g_new - g
        sy, ns, ny, yy, f_new_h, gmax_new = _host(
            T, torch.dot(s_vec, y_vec), torch.linalg.vector_norm(s_vec),
            torch.linalg.vector_norm(y_vec), torch.dot(y_vec, y_vec), f_new,
            g_new.abs().max())
        if ok and sy > T(1e-10) * ns * ny:  # store the pair
            s_hist[head] = s_vec
            y_hist[head] = y_vec
            rho_hist[head] = T(1) / max(sy, T(1e-30))
            head = (head + 1) % m
            count = min(count + 1, m)
            gamma = sy / max(yy, T(1e-30))

        f_old = f_h
        if ok:
            x, f, g, f_h, gmax = x_new, f_new, g_new, f_new_h, gmax_new
        g_small = gmax <= T(gtol)
        f_flat = ok and (f_old - f_h) <= T(ftol) * max(max(abs(f_old), abs(f_h)), T(1))
        converged = bool(g_small or f_flat)
        k += 1
        evals += ls_evals
        stop = converged or k >= max_iters or not ok
    return LBFGSResult(x=x, f=f, g=g, n_iters=k, n_evals=evals, converged=converged)


def ravel_tree(tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], object]]:
    """(flat, unravel) in ``jax.flatten_util.ravel_pytree``'s order (dict keys
    sorted, lists in order). ``unravel(flat)`` rebuilds the tree from views of
    ``flat``."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    shapes = [t.shape for t in leaves]

    def unravel(v: torch.Tensor):
        parts = iter(p.view(s) for p, s in zip(v.split([int(np.prod(s)) for s in shapes]),
                                               shapes))

        def build(t):
            if isinstance(t, dict):
                rebuilt = {key: build(t[key]) for key in sorted(t)}
                return {key: rebuilt[key] for key in t}
            if isinstance(t, (list, tuple)):
                return type(t)(build(u) for u in t)
            return next(parts)

        return build(tree)

    return flat, unravel


def lbfgs_minimize_pytree(
    loss_fn: Callable,
    params,
    max_iters: int = 5000,
    history: int = 50,
    ftol: float = 1e-7,
    gtol: float = 1e-5,
    max_ls: int = 50,
):
    """Tree front-end: flattens params, minimizes, unflattens. ``loss_fn``
    takes the params tree and returns a 0-d tensor. Frozen leaves should be
    detached by ``loss_fn`` (they then get a zero gradient)."""
    x0, unravel = ravel_tree(params)
    res = lbfgs_minimize(lambda x: loss_fn(unravel(x)), x0.detach(), max_iters=max_iters,
                         history=history, ftol=ftol, gtol=gtol, max_ls=max_ls)
    return unravel(res.x), res
