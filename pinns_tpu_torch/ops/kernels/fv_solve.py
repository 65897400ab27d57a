"""Wrapper of K12, the data generators' finite-volume time stepper
(``csrc/fv_solve.cu``), and its plain version.

K12 replaces the JAX package's ``lax.scan`` programs of ``euler_solve`` and
``burgers_fv`` (``pinns_tpu/data/generators.py:141``, ``:205``): a whole
SSP-RK3 solve of the MUSCL-minmod scheme, the pre-steps and every snapshot,
in one launch of one CTA that keeps the state in shared memory. The header
of ``csrc/fv_solve.cu`` has what bounds it and the design.

:func:`burgers_trajectory` and :func:`euler_trajectory` launch K12 on a
float32 CUDA state and run the plain version (``data.generators``'
``burgers_rhs`` / ``euler_rhs`` stepped by ``rk3``) on a CPU one, in float32
or float64. On the card they raise ``NotImplementedError`` for what K12 does
not take (float64; more cells than one CTA's shared memory holds) and never
fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from pinns_tpu_torch.data.generators import burgers_rhs, euler_rhs, fv_trajectory_reference
from pinns_tpu_torch.device import raw_stream
from pinns_tpu_torch.ops.kernels import build

BURGERS_LAUNCHES = 0  # K12 launches of a Burgers solve in this process (chip_smoke.py reads it)
EULER_LAUNCHES = 0  # K12 launches of an Euler solve
_launches_lock = threading.Lock()
EULER_EPS = 1e-12  # the sound speed's floor, c^2 >= EULER_EPS (generators._euler_max_speed)
N_SCALARS = 9
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library("fv_solve")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pinns_fv_burgers.argtypes = [p, i, i, i, p, i, i, i, p, i, p]
        lib.pinns_fv_burgers.restype = i
        lib.pinns_fv_euler.argtypes = [p, i, p, i, i, p, i, p]
        lib.pinns_fv_euler.restype = i
        lib.pinns_fv_smem_optin.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.pinns_fv_smem_optin.restype = i
        lib.pinns_fv_error_string.argtypes = [i]
        lib.pinns_fv_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def smem_bytes(n: int, euler: bool) -> int:
    """K12's shared memory at n cells: Q, S1, S2, D (n floats each, Euler
    3 n) and the face fluxes (n + 1, Euler 3 (n + 1))."""
    return 4 * (15 * n + 3) if euler else 4 * (5 * n + 1)


def max_cells(smem_limit: int, euler: bool) -> int:
    """The largest cell count whose buffers fit ``smem_limit`` bytes."""
    return (smem_limit // 4 - 3) // 15 if euler else (smem_limit // 4 - 1) // 5


@functools.lru_cache(maxsize=None)
def smem_limit(index: int) -> int:
    """The shared memory a block of CUDA device ``index`` may opt into."""
    out = ctypes.c_int(0)
    err = _lib().pinns_fv_smem_optin(index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"K12: cannot read device {index}'s shared memory limit ({err})")
    return out.value


def reciprocal(b: float) -> np.float32:
    """b's reciprocal as ATen forms it to divide a float32 CUDA tensor by the
    host scalar b: taken in double, rounded to float."""
    return np.float32(1.0 / b)


@functools.lru_cache(maxsize=None)
def check_scalar_division(index: int) -> None:
    """Raise unless ATen divides a float32 CUDA tensor by a host scalar on
    device ``index`` as a multiply by :func:`reciprocal` (its
    ``div_true_kernel_cuda``), the one rule K12 follows. 1/3 and 1/7 tell it
    from a true division; the squares of these grid spacings from a
    reciprocal taken in float."""
    x = np.asarray([1.0, 5.0, 7.0, 10.0, 11.0, 13.0, 0.3, 2.7, 0.1, 9.5], np.float32)
    for b in (3.0, 7.0, 0.0004884004592895508 ** 2, 0.003067959100008011 ** 2):
        got = (torch.from_numpy(x).to(f"cuda:{index}") / b).cpu().numpy()
        if not np.array_equal(got, x * reciprocal(b)):
            raise RuntimeError(
                f"K12: ATen's division by the host scalar {b} on cuda:{index} is not a multiply "
                "by its reciprocal taken in double and rounded to float, the rule K12 follows")


def _scalars(dx: float, dt: float, nu: float, gamma: float) -> ctypes.Array:
    """K12's float32 scalars: each value as ATen rounds a host scalar, and the
    reciprocals 1/dx, 1/(dx dx), 1/3 as ATen forms them."""
    f = np.float32
    vals = [f(dt), reciprocal(dx), reciprocal(dx * dx), f(nu), reciprocal(3.0), f(2.0 / 3.0),
            f(gamma), f(gamma - 1.0), f(EULER_EPS)]
    return (ctypes.c_float * N_SCALARS)(*[float(v) for v in vals])


def check_scope(n: int, euler: bool, dtype: torch.dtype, limit: int) -> None:
    """Raise ``NotImplementedError`` for a solve K12 does not take: a dtype
    other than float32, or more cells than ``limit`` bytes of one CTA's
    shared memory hold. The message names the CPU path and the later
    design."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"K12 steps a float32 state; a {dtype} solve runs the plain version with "
            "--device cpu")
    if smem_bytes(n, euler) > limit:
        mode = "Euler" if euler else "Burgers"
        raise NotImplementedError(
            f"K12 holds at most {max_cells(limit, euler)} {mode} cells in one CTA's shared "
            f"memory ({limit} bytes), got {n}: generate this grid with --device cpu (the plain "
            "version), or wait for K12's cluster design for larger grids (ROADMAP queue 2)")


def _check(state: torch.Tensor, euler: bool, steps: int, n_snap: int, offset: int) -> int:
    shape_ok = state.dim() == 2 and state.shape[1] == 3 if euler else state.dim() == 1
    if not shape_ok:
        want = "(n, 3)" if euler else "(n,)"
        raise ValueError(f"K12 takes a {want} state, got {tuple(state.shape)}")
    n = state.shape[0]
    if n < 3:
        raise ValueError(f"K12 takes at least 3 cells, got {n}")
    if steps < 1 or n_snap < 1 or offset < 0:
        raise ValueError(f"K12: steps {steps}, snapshots {n_snap}, pre-steps {offset}")
    if state.device.type == "cpu":
        return n
    if state.device.type != "cuda":
        raise ValueError(f"K12 runs on a CUDA device, got {state.device}")
    check_scope(n, euler, state.dtype, smem_limit(state.get_device()))
    return n


def burgers_trajectory(u0: torch.Tensor, dx: float, dt: float, steps_per_snap: int,
                       n_snap: int, nu: float = 0.0, periodic: bool = False,
                       offset_steps: int = 0) -> torch.Tensor:
    """(n_snap, n): ``offset_steps`` RK3 steps of the Burgers scheme
    (``generators.burgers_rhs``) from ``u0`` (n,), then a snapshot every
    ``steps_per_snap`` steps, the first the state after the pre-steps. One
    K12 launch on a CUDA state, the plain version on a CPU one."""
    global BURGERS_LAUNCHES
    n = _check(u0, False, steps_per_snap, n_snap, offset_steps)
    if u0.device.type == "cpu":
        return burgers_trajectory_reference(u0, dx, dt, steps_per_snap, n_snap, nu, periodic,
                                            offset_steps)
    index = u0.get_device()
    u0 = u0.contiguous()
    out = torch.empty((n_snap, n), dtype=torch.float32, device=u0.device)
    check_scalar_division(index)
    lib = _LIB or _lib()
    err = lib.pinns_fv_burgers(
        u0.data_ptr(), n, int(periodic), int(nu > 0), _scalars(dx, dt, nu, 1.4),
        steps_per_snap, n_snap, offset_steps, out.data_ptr(), index, raw_stream(index))
    if err != 0:
        msg = lib.pinns_fv_error_string(err).decode()
        raise RuntimeError(f"K12 (fv_burgers) launch failed: CUDA error {err} ({msg}); n {n}")
    with _launches_lock:
        BURGERS_LAUNCHES += 1
    return out


def burgers_trajectory_reference(u0: torch.Tensor, dx: float, dt: float, steps_per_snap: int,
                                 n_snap: int, nu: float = 0.0, periodic: bool = False,
                                 offset_steps: int = 0) -> torch.Tensor:
    """The plain version of :func:`burgers_trajectory`, on u0's device."""
    return fv_trajectory_reference(u0, lambda u: burgers_rhs(u, dx, nu, periodic), dt,
                                   steps_per_snap, n_snap, offset_steps)


def euler_trajectory(q0: torch.Tensor, dx: float, dt: float, steps_per_snap: int, n_snap: int,
                     gamma: float = 1.4) -> torch.Tensor:
    """(n_snap, n, 3): a snapshot of the Euler scheme (``generators.
    euler_rhs``) every ``steps_per_snap`` RK3 steps from ``q0`` (n, 3), the
    first ``q0`` itself. One K12 launch on a CUDA state, the plain version
    on a CPU one."""
    global EULER_LAUNCHES
    n = _check(q0, True, steps_per_snap, n_snap, 0)
    if q0.device.type == "cpu":
        return euler_trajectory_reference(q0, dx, dt, steps_per_snap, n_snap, gamma)
    index = q0.get_device()
    q0 = q0.contiguous()
    out = torch.empty((n_snap, n, 3), dtype=torch.float32, device=q0.device)
    check_scalar_division(index)
    lib = _LIB or _lib()
    err = lib.pinns_fv_euler(
        q0.data_ptr(), n, _scalars(dx, dt, 0.0, gamma), steps_per_snap, n_snap,
        out.data_ptr(), index, raw_stream(index))
    if err != 0:
        msg = lib.pinns_fv_error_string(err).decode()
        raise RuntimeError(f"K12 (fv_euler) launch failed: CUDA error {err} ({msg}); n {n}")
    with _launches_lock:
        EULER_LAUNCHES += 1
    return out


def euler_trajectory_reference(q0: torch.Tensor, dx: float, dt: float, steps_per_snap: int,
                               n_snap: int, gamma: float = 1.4) -> torch.Tensor:
    """The plain version of :func:`euler_trajectory`, on q0's device."""
    return fv_trajectory_reference(q0, lambda q: euler_rhs(q, dx, gamma), dt, steps_per_snap,
                                   n_snap)
