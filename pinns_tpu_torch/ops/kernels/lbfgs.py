"""K10: the L-BFGS solve on the device (``csrc/lbfgs.cu``), its wrappers, the
kernels' algorithm in plain PyTorch, and the solver the trainer's L-BFGS
phase takes on the card.

Replaces the XLA program of ``pinns_tpu/opt/lbfgs.py::lbfgs_minimize``
(``:194``, its ``lax.while_loop`` ``:306``), with ``_zoom_linesearch``
(``:38``) and ``_two_loop_direction`` (``:167``): what
``opt/lbfgs.py::lbfgs_minimize`` computes from the host, branch for branch,
with every decision taken on the device. A solve is a chain of *evaluation
steps*, each

    value-and-grad (phi, g) at the trial point -> control -> direction

where the value-and-grad is K3's (``fused_step.fused_value_and_grad``: the
narrow grad kernel and the partials' sum) for a configuration inside
:func:`lbfgs_device_supported` (:class:`DeviceLBFGS`), else autograd through
the loss over the kernels it runs (K7a, K7b, K5, K1 / K2:
:class:`AutogradLBFGS`, every other float32 configuration on the card, the
Euler L-BFGS branch among them), and the control and direction kernels carry
the solve's state in device memory (:class:`Buffers`). The direction kernel
runs as a thread block cluster of ``CLUSTER`` CTAs (:func:`cluster_plan`:
at ``abgrall_admm``'s 3,023 params the history's pairs resident in their
shared memory; each step's sum gathered through distributed shared memory);
the control kernel as one block; both keep one 1,024-thread block's sum
order, so their bits do not depend on the layout.
:class:`SolveLoop` runs a solve as one launch of a CUDA graph: the steps
(``k`` a body iteration) are the body of a conditional WHILE node that the
control kernel ends when it sets the done flag, the port of JAX's
``while_loop``; the host reads the device once a solve (``opt.lbfgs.
HOST_SYNCS``), and at most k - 1 steps run after the end (every launch of
them reads the flag and returns). :class:`DeviceLBFGS` captures its loop
once per (rho, shape); :class:`AutogradLBFGS` captures autograd through the
loss as the evaluation, anew for each solve. The stepwise drive
(:func:`run_steps`) and ``opt/lbfgs.py::lbfgs_minimize``, the host loop,
stay the algorithm's plain drives (the CPU's, and the card's checks).

:class:`LBFGSChunk` runs a chunk of outer epochs on the card (JAX's
``make_chunked`` over its ``make_lbfgs_step``): each solve one launch of its
loop, then one more graph, K3's post-update mode
(``fused_step.fused_post_update``: the next batch, z, dual and the metrics
row, in place in the solve's buffers) and the reset in place, which starts
the next solve from this one's iterate.

The kernels' plain versions (:func:`reset_reference`,
:func:`control_reference`, :func:`direction_reference`) step the same state
on tensors in the kernels' arithmetic: numpy scalars of the solve's dtype,
one torch operation a rounding for the vectors, and every sum in the
kernels' fixed order (:func:`block_sum_reference`), so a kernel and its
plain version agree bit for bit on the same inputs.

The float64 mode: :class:`Buffers` of float64 (``Buffers.alloc(..., dtype=
torch.float64)``) take the same kernels instantiated on double (the
``*_f64`` entry points) and the same plain versions in float64, with the
constants rounded to double (``solve_constants(dtype=np.float64)``). Double
pairs take twice the shared memory, so :func:`cluster_plan` counts 8-byte
words (at 8x20 and a history of 50 the pairs are streamed).
:class:`AutogradLBFGS` takes a float64 ``x0`` into it: ``polish`` on the
card. :class:`DeviceLBFGS` (K3's value-and-grad) stays float32. Each
wrapper runs the plain version on CPU tensors and the kernel on CUDA tensors
(or raises); nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.opt import lbfgs as host_lbfgs
from pinns_tpu_torch.parallel import sharding

RESET_LAUNCHES = 0  # reset kernel launches (one a solve; LBFGSChunk's in place too)
# control and direction kernel launches: host calls, and the steps run inside
# a solve's loop (the device's step counter: SolveLoop.count)
CONTROL_LAUNCHES = 0
DIRECTION_LAUNCHES = 0
LOOP_LAUNCHES = 0  # launches of a solve's WHILE-node graph (SolveLoop: one a solve)
# evaluation steps run inside those launches, as the control kernel counts
# them on the device (Buffers.steps), and of those the steps after a solve's
# end (at most k - 1 a solve)
LOOP_STEPS = 0
STEPS_AFTER_END = 0
SHARD_REPLAYS = 0  # replays of a sharded solve's graph of SYNC_EVERY steps (SolveReplay)
SOLVES = 0  # device solves (DeviceLBFGS.minimize and AutogradLBFGS.minimize on the card)
CHUNK_EPOCHS = 0  # outer epochs LBFGSChunk ran on the card (a post-update replay each)
# launches of the float64 mode's kernels (host calls and steps inside a loop)
RESET_F64_LAUNCHES = CONTROL_F64_LAUNCHES = DIRECTION_F64_LAUNCHES = 0
_lock = threading.Lock()

# the stepwise drive (run_steps: the CPU's and the card's checks, and
# AutogradLBFGS(captured=False)) reads the done flag once every SYNC_EVERY
# steps
SYNC_EVERY = 16
# k, the evaluation steps a body iteration of a solve's WHILE node runs, per
# solver, from the times of k = 1, 4 and 16 on the card (PERF.md,
# scripts/lbfgs_loop_steps.py): a solve of n_evals evaluations runs
# ceil(n_evals / k) body iterations, so at most k - 1 steps after its end.
# An empty step costs DeviceLBFGS four launches that return at once, and
# AutogradLBFGS a whole forward and backward.
DEVICE_STEPS = 4
AUTOGRAD_STEPS = 1
THREADS = 1024  # the kernels' virtual block (csrc/lbfgs.cu: kThreads)
WARPS = THREADS // 32
CLUSTER = 8  # the direction kernel's CTAs (csrc/lbfgs.cu: kCtas)
SMEM_LIMIT = 232_448  # a block's shared memory on sm_90 (csrc/lbfgs.cu: kSmemLimit)
# the static shared memory the plan reserves, by the item size of the
# solve's dtype (csrc/lbfgs.cu: static_reserve)
STATIC_SMEM = {4: 1_024, 8: 2_048}
DTYPES = (torch.float32, torch.float64)  # the float32 kernels and the float64 mode
MAX_REGISTER_ENTRIES = 8  # entries of q a thread holds in registers (kMaxPer)

# the state's int slots (csrc/lbfgs.cu: IntSlot)
(I_DONE, I_CONVERGED, I_K, I_EVALS, I_STAGE, I_NEED_DIR, I_LS_EVALS, I_COUNT, I_HEAD, I_MODE,
 I_BRANCHES, I_MAX_ITERS, I_MAX_LS) = range(13)
N_INTS = 13
# the float slots (FloatSlot)
(F_F, F_GAMMA, F_DPHI0, F_A_LO, F_PHI_LO, F_DPHI_LO, F_A_HI, F_PHI_HI, F_A_PREV, F_PHI_PREV,
 F_DPHI_PREV, F_A_TRIAL, F_A_BEST, F_F_BEST, F_PHI_T, F_C1, F_C2, F_FTOL, F_GTOL, F_EPS_DEAD,
 F_EPS_CURV, F_TINY, F_A_MAX, F_EPS_STEP) = range(24)
N_FLOATS = 24
# the rows of vec: the iterate, its gradient, the direction, the trial point
# (the value-and-grad's input), the trial's gradient (its output), the
# search's best gradient
X, G, D, XT, GT, GB = range(6)
N_ROWS = 6
STAGE_INIT, STAGE_SEARCH = 0, 1
# the branches a solve took, or-ed into si[I_BRANCHES] (csrc/lbfgs.cu: Branch)
BRANCHES = {"extend": 1 << 0, "zoom_hi": 1 << 1, "zoom_rev": 1 << 2, "zoom_cond_hi": 1 << 3,
            "zoom_lo": 1 << 4, "swap": 1 << 5, "accept": 1 << 6, "out_of_budget": 1 << 7,
            "interval_dead": 1 << 8, "fallback": 1 << 9, "failed": 1 << 10,
            "descent_guard": 1 << 11, "curvature_skip": 1 << 12, "stored": 1 << 13}
# the constants of the algorithm other than its options, as JAX's float32
# arithmetic rounds them: the interval-dead test, the curvature test, the
# floors of s.y and y.y, the bracket's largest step, the floor of sum|g|
CONSTANTS = (1e-12, 1e-10, 1e-30, 1e8, 1e-12)


def lbfgs_device_supported(exp, spec: MLPSpec) -> List[str]:
    """Why ``exp``'s L-BFGS phase is outside K10's scope (empty when it is
    inside): its loss must be one that K3's narrow grad kernel computes.

    K3's scope (``fused_step.fused_step_supported``) without its Adam-only
    limits, which the value-and-grad does not read (the learning-rate
    schedule, the sampling strategy and the time curriculum, which only
    choose the batch, and ``admm_update_points``, the tail's); with K3's
    narrow design (every width at most ``NARROW_WIDTH``), since the
    value-and-grad is that design's.
    """
    lo = exp.loss
    reasons = [
        (exp.pde.kind != "burgers", f"pde.kind={exp.pde.kind!r}"),
        (exp.pde.train_coeffs, "trainable PDE coefficients (their gradient is not K3's)"),
        (exp.sampling.microbatch > 1, "microbatching"),
        (lo.data_kind != "mse_sum", f"loss.data_kind={lo.data_kind!r}"),
        (lo.data_weight != 1.0 or lo.residual_weight != 1.0, "loss weights other than 1"),
        (lo.residual_kind not in k_fused.KINDS, f"loss.residual_kind={lo.residual_kind!r}"),
        (lo.admm_form != "strong", "the weak-form ADMM residual"),
        (lo.entropy_weight > 0.0 or lo.grad_weight_kappa != 0.0 or lo.causal_eps > 0.0,
         "entropy, gradient or causal weighting"),
        (spec.dtype != torch.float32 or spec.mixed,
         "a dtype other than float32 or a mixed policy (K3's float64 value-and-grad is left to "
         "a later slice, ROADMAP queue 2; a float64 solve takes AutogradLBFGS)"),
        (spec.n_paths > 0 or spec.fourier,
         "shock-path or Fourier features (K3's value-and-grad computes no input embedding: "
         "ROADMAP queue 2; AutogradLBFGS takes them)"),
        (spec.in_dim != 2 or spec.out_dim != 1, f"widths {spec.layers} (needs 2 -> ... -> 1)"),
        (max(spec.layers) > k_fused.NARROW_WIDTH,
         f"a width above {k_fused.NARROW_WIDTH} (K3's wide design has no value-and-grad mode)"),
        (not 2 <= len(spec.layers) - 1 <= k_fused.MAX_LAYERS,
         f"{len(spec.layers) - 1} layers (needs 2 to {k_fused.MAX_LAYERS})"),
    ]
    out = [why for bad, why in reasons if bad]
    if not out and k_fused.launch_config(spec.layers)[0] == 0:
        out.append(f"widths {spec.layers}: no grad tile of K3's fits a block")
    return out


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The direction kernel's layout at (n, m) on its CLUSTER CTAs of
    ``THREADS // CLUSTER`` threads: each thread ``per`` entries of a
    vector; the pairs ``resident`` in the CTAs' shared memory or streamed
    from global memory; ``smem`` bytes of shared memory a CTA."""

    resident: bool
    per: int
    smem: int


def direction_smem(n: int, m: int, resident: bool, itemsize: int = 4) -> int:
    """Shared memory a CTA of the direction kernel takes (csrc/lbfgs.cu::
    direction_smem): the static reserve, then in words of the solve's dtype
    (``itemsize`` bytes: 4 for float32, 8 for the float64 mode) alpha (m a
    warp), rho and the pairs' slots (m each), q when it does not fit in
    registers (per entries a thread) and the resident pairs (2 m per entries
    a thread)."""
    tpb, per = THREADS // CLUSTER, -(-n // THREADS)
    words = (tpb // 32) * m + 2 * m + (per * tpb if per > MAX_REGISTER_ENTRIES else 0) \
        + (2 * m * per * tpb if resident else 0)
    return STATIC_SMEM[itemsize] + itemsize * words


def cluster_plan(n: int, m: int, itemsize: int = 4) -> ClusterPlan:
    """The direction kernel's layout for n params and a history of m in a
    dtype of ``itemsize`` bytes: the pairs resident where the CTAs hold them
    in SMEM_LIMIT, else streamed. Raises where not even the streamed layout
    fits."""
    per = -(-n // THREADS)
    for resident in (True, False):
        smem = direction_smem(n, m, resident, itemsize)
        if smem <= SMEM_LIMIT:
            return ClusterPlan(resident, per, smem)
    raise ValueError(f"K10: n = {n}, m = {m} needs {smem} bytes of shared memory a CTA even "
                     f"with the pairs streamed (limit {SMEM_LIMIT})")


def net_offset(params) -> int:
    """Where the net begins in ``ravel_tree(params)``: the solve's flat
    order is JAX's ``ravel_pytree`` order (dict keys sorted), so the frozen
    coefficients come first and the net follows in ``pack_params`` order,
    the order K3 reads."""
    if sorted(params) != ["coeffs", "net"]:
        raise ValueError(f"K10: params with keys {sorted(params)} (needs coeffs and net)")
    return int(sum(t.numel() for t in params["coeffs"].values()))


# -- the state -------------------------------------------------------------------

@dataclasses.dataclass
class Buffers:
    """A solve's device state: ``si`` (N_INTS int32), ``sf`` (N_FLOATS),
    ``vec`` (N_ROWS, n), ``hist`` (2, m, n) (the s rows, then the y rows)
    and ``rho`` (m), all but ``si`` in the solve's dtype (float32, or
    float64 for the float64 mode). Beside the state, ``steps`` (one int32,
    zeros by default) counts the control kernel's launches since the reset,
    those after the solve's end included: the steps it ran."""

    si: torch.Tensor
    sf: torch.Tensor
    vec: torch.Tensor
    hist: torch.Tensor
    rho: torch.Tensor
    steps: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.steps is None:
            self.steps = torch.zeros(1, dtype=torch.int32, device=self.si.device)

    @staticmethod
    def alloc(n: int, m: int, device, dtype: torch.dtype = torch.float32) -> "Buffers":
        z = lambda *shape, dtype=dtype: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=device)
        return Buffers(si=z(N_INTS, dtype=torch.int32), sf=z(N_FLOATS), vec=z(N_ROWS, n),
                       hist=z(2, m, n), rho=z(m))

    @property
    def dtype(self) -> torch.dtype:
        return self.vec.dtype

    @property
    def n(self) -> int:
        return self.vec.shape[1]

    @property
    def m(self) -> int:
        return self.rho.shape[0]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(si, sf, vec, hist, rho), the state's buffers themselves."""
        return self.si, self.sf, self.vec, self.hist, self.rho

    def clone(self) -> "Buffers":
        return Buffers(*(t.clone() for t in self.tensors()), steps=self.steps.clone())

    def check(self) -> None:
        n, m, dev, dt = self.n, self.m, self.si.device, self.dtype
        if dt not in DTYPES:
            raise ValueError(f"K10 solves in float32 or float64, got {dt}")
        for name, t, shape, dtype in (("si", self.si, (N_INTS,), torch.int32),
                                      ("sf", self.sf, (N_FLOATS,), dt),
                                      ("vec", self.vec, (N_ROWS, n), dt),
                                      ("hist", self.hist, (2, m, n), dt),
                                      ("rho", self.rho, (m,), dt),
                                      ("steps", self.steps, (1,), torch.int32)):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"K10: {name} must be contiguous {dtype} {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if n < 1 or m < 1:
            raise ValueError(f"K10: n = {n}, m = {m}")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"K10 needs CPU or CUDA tensors, got device {dev}")


def _load(b: Buffers) -> Tuple[np.ndarray, np.ndarray]:
    return b.si.cpu().numpy().copy(), b.sf.cpu().numpy().copy()


def _store(b: Buffers, I: np.ndarray, F: np.ndarray) -> None:
    b.si.copy_(torch.from_numpy(I))
    b.sf.copy_(torch.from_numpy(F))


def _np_dtype(b: Buffers):
    """The numpy scalar type of the solve's dtype: the plain versions' scalar
    arithmetic rounds in it, as the kernels' does."""
    return np.float64 if b.dtype == torch.float64 else np.float32


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """A numpy scalar as a 0-d tensor of ``like``'s dtype beside it."""
    return torch.tensor(float(v), dtype=like.dtype, device=like.device)


def _scalar(t: torch.Tensor):
    """A 0-d tensor as a numpy scalar of its own dtype."""
    return (np.float64 if t.dtype == torch.float64 else np.float32)(t.item())


# -- the plain versions ----------------------------------------------------------

def block_sum_reference(terms: torch.Tensor) -> torch.Tensor:
    """The kernels' sum of ``terms`` (n,) in their dtype, 0-d: thread t adds
    entries t, t + THREADS, ... in turn from 0, each warp's 32 sums meet in
    the butterfly of offsets 16, 8, 4, 2, 1, and the WARPS warps' sums in the
    butterfly of offsets WARPS / 2, ..., 1."""
    n = terms.shape[0]
    k = -(-n // THREADS)
    padded = torch.zeros(k * THREADS, dtype=terms.dtype, device=terms.device)
    padded[:n] = terms
    rows = padded.view(k, THREADS)
    acc = torch.zeros(THREADS, dtype=terms.dtype, device=terms.device)
    for r in range(k):
        acc = acc + rows[r]
    w = acc.view(WARPS, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[:, :off] + w[:, off:2 * off]
    w = w.reshape(WARPS)
    off = WARPS // 2
    while off >= 1:
        w = w[:off] + w[off:2 * off]
        off //= 2
    return w[0]


def block_dot_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return block_sum_reference(a * b)


def two_loop_reference(g, s_hist, y_hist, rho, count: int, head: int, gamma) -> torch.Tensor:
    """d = -H g over the ``count`` newest pairs of the circular history (m, n)
    that ends before ``head``, in the direction kernel's arithmetic."""
    m = s_hist.shape[0]
    q = g.clone()
    alpha = {}
    for j in range(count):  # newest first
        idx = (head - 1 - j) % m
        alpha[idx] = rho[idx] * block_dot_reference(s_hist[idx], q)
        q = q - alpha[idx] * y_hist[idx]
    r = _t(gamma, g) * q
    for j in range(count):  # oldest first
        idx = (head - count + j) % m
        beta = rho[idx] * block_dot_reference(y_hist[idx], r)
        r = r + (alpha[idx] - beta) * s_hist[idx]
    return -r


def reset_reference(b: Buffers, x0: Optional[torch.Tensor], max_iters: int, max_ls: int,
                    consts: np.ndarray) -> None:
    """A solve's initial state: the trial point x0 (stage init), gamma 1;
    with x0 None the reset in place, from the iterate vec[X] that the last
    solve left."""
    I = np.zeros(N_INTS, np.int32)
    F = np.zeros(N_FLOATS, _np_dtype(b))
    I[I_STAGE], I[I_MAX_ITERS], I[I_MAX_LS] = STAGE_INIT, max_iters, max_ls
    F[F_GAMMA] = 1.0
    F[F_C1:F_EPS_STEP + 1] = consts
    _store(b, I, F)
    b.steps.zero_()
    if x0 is not None:
        b.vec[X].copy_(x0)
    b.vec[XT].copy_(b.vec[X])
    b.vec[GT].zero_()


def seeded_state(n: int, m: int, count: int, head: int, seed: int, device="cpu",
                 gamma: Optional[float] = None, dtype: torch.dtype = torch.float32) -> Buffers:
    """A state at an iteration's start (stage search, need_dir set) with
    ``count`` pairs of a seeded history ending before ``head``: s normal,
    y = s w with w uniform in [0.5, 2] (so s.y > 0), rho = 1 / s.y, gamma
    s.y / y.y of the newest pair unless given; x and g normal, f 1, the
    default constants, all in ``dtype``. For the kernels' checks and
    timings; a negative ``gamma`` turns the two-loop's direction uphill (the
    descent guard)."""
    rng = np.random.default_rng(seed)
    b = Buffers.alloc(n, m, "cpu", dtype)
    T = _np_dtype(b)
    I = np.zeros(N_INTS, np.int32)
    F = np.zeros(N_FLOATS, T)
    I[I_STAGE], I[I_NEED_DIR], I[I_COUNT], I[I_HEAD] = STAGE_SEARCH, 1, count, head % m
    I[I_MAX_ITERS], I[I_MAX_LS] = 1_000, 50
    F[F_F], F[F_GAMMA] = 1.0, 1.0
    F[F_C1:F_EPS_STEP + 1] = solve_constants(dtype=T)
    for j in range(count):  # oldest first
        idx = (head - count + j) % m
        s = rng.standard_normal(n).astype(T)
        y = (s * rng.uniform(0.5, 2.0, n)).astype(T)
        sy, yy = T(s @ y), T(y @ y)
        b.hist[0, idx], b.hist[1, idx] = torch.from_numpy(s), torch.from_numpy(y)
        b.rho[idx] = float(T(1.0) / sy)
        F[F_GAMMA] = sy / yy
    if gamma is not None:
        F[F_GAMMA] = gamma
    _store(b, I, F)
    b.vec[X] = torch.from_numpy(rng.standard_normal(n).astype(T))
    b.vec[G] = torch.from_numpy(rng.standard_normal(n).astype(T))
    return Buffers(*(t.to(device) for t in b.tensors()))


def _search_update(I, F, phi, dphi) -> Tuple[bool, bool, bool]:
    """``csrc/lbfgs.cu::search_update``: one evaluation into the search.
    Returns (better, ended, ok)."""
    R = F.dtype.type  # the solve's scalar type
    a, f0, dphi0 = F[F_A_TRIAL], F[F_F], F[F_DPHI0]
    evals = I[I_LS_EVALS] + 1
    I[I_LS_EVALS] = evals
    out_of_budget = evals >= I[I_MAX_LS]
    wolfe1 = phi <= f0 + F[F_C1] * a * dphi0
    wolfe2 = abs(dphi) <= -F[F_C2] * dphi0
    accept = bool(wolfe1 and wolfe2)
    br = 0
    if I[I_MODE] == 0:  # alg. 3.5: bracket
        hi_cond = (not wolfe1) or (phi >= F[F_PHI_PREV] and evals > 1)
        to_rev = (not hi_cond) and dphi >= 0
        if hi_cond:
            F[F_A_LO], F[F_PHI_LO], F[F_DPHI_LO] = F[F_A_PREV], F[F_PHI_PREV], F[F_DPHI_PREV]
            F[F_A_HI], F[F_PHI_HI] = a, phi
            br |= BRANCHES["zoom_hi"]
        elif to_rev:
            F[F_A_HI], F[F_PHI_HI] = F[F_A_PREV], F[F_PHI_PREV]
            F[F_A_LO], F[F_PHI_LO], F[F_DPHI_LO] = a, phi, dphi
            br |= BRANCHES["zoom_rev"]
        if hi_cond or to_rev:
            I[I_MODE] = 1
            F[F_A_TRIAL] = R(0.5) * (F[F_A_LO] + F[F_A_HI])
        else:
            F[F_A_TRIAL] = np.minimum(R(2) * a, F[F_A_MAX])
            br |= BRANCHES["extend"]
        F[F_A_PREV], F[F_PHI_PREV], F[F_DPHI_PREV] = a, phi, dphi
    else:  # alg. 3.6 with bisection trial points
        cond_hi = (not wolfe1) or phi >= F[F_PHI_LO]
        swap = (not cond_hi) and dphi * (F[F_A_HI] - F[F_A_LO]) >= 0
        if cond_hi:
            F[F_A_HI], F[F_PHI_HI] = a, phi
            br |= BRANCHES["zoom_cond_hi"]
        else:
            if swap:
                F[F_A_HI], F[F_PHI_HI] = F[F_A_LO], F[F_PHI_LO]
                br |= BRANCHES["swap"]
            F[F_A_LO], F[F_PHI_LO], F[F_DPHI_LO] = a, phi, dphi
            br |= BRANCHES["zoom_lo"]
        F[F_A_TRIAL] = R(0.5) * (F[F_A_LO] + F[F_A_HI])
    interval_dead = I[I_MODE] == 1 and (
        abs(F[F_A_HI] - F[F_A_LO]) <= F[F_EPS_DEAD] * np.maximum(R(1), abs(F[F_A_HI])))
    fail = (not accept) and (out_of_budget or interval_dead)
    better = bool((wolfe1 and phi < F[F_F_BEST]) or accept)
    if better:
        F[F_A_BEST], F[F_F_BEST] = a, phi
    ok = bool(accept or F[F_F_BEST] < f0)
    if accept:
        br |= BRANCHES["accept"]
    if fail:
        br |= (BRANCHES["out_of_budget"] if out_of_budget else 0) | (
            BRANCHES["interval_dead"] if interval_dead else 0)
        br |= BRANCHES["fallback"] if ok else BRANCHES["failed"]
    I[I_BRANCHES] |= br
    return better, bool(accept or fail), ok


def control_reference(b: Buffers, cond: Optional[List[int]] = None) -> None:
    """The control kernel in plain PyTorch: takes the evaluation at the
    trial point (phi in sf[F_PHI_T], its gradient in vec[GT]); see
    ``csrc/lbfgs.cu::control_kernel``. ``cond``, the WHILE node's condition
    in the loop's plain drive (:func:`loop_reference`), is set to 0 where
    the kernel sets it: once the done flag is set or found set. Every call
    adds one to ``b.steps``."""
    b.steps.add_(1)
    _control_reference(b)
    if cond is not None and int(b.si[I_DONE]):
        cond[0] = 0


def _control_reference(b: Buffers) -> None:
    I, F = _load(b)
    if I[I_DONE]:
        return
    x, g, d, xt, gt, gb = b.vec
    m = b.m
    if I[I_STAGE] == STAGE_INIT:  # the first evaluation: f and g at x0
        g.copy_(gt)
        F[F_F] = F[F_PHI_T]
        I[I_EVALS] = 1
        if _scalar(gt.abs().max()) <= F[F_GTOL]:  # an already-converged start
            I[I_DONE] = I[I_CONVERGED] = 1
        else:
            I[I_NEED_DIR] = 1
        _store(b, I, F)
        return
    dphi = _scalar(block_dot_reference(gt, d))
    better, ended, ok = _search_update(I, F, F[F_PHI_T], dphi)
    if better:
        gb.copy_(gt)
    if not ended:  # the next trial point
        xt.copy_(x + _t(F[F_A_TRIAL], x) * d)
        _store(b, I, F)
        return
    # the end of the iteration: x_new = x + a d, s = x_new - x, y = g_new - g
    xn = x + _t(F[F_A_BEST], x) * d
    s, y = xn - x, gb - g
    sy, ss, yy = (_scalar(block_sum_reference(v)) for v in (s * y, s * s, y * y))
    R = F.dtype.type
    store = ok and sy > F[F_EPS_CURV] * np.sqrt(ss) * np.sqrt(yy)
    head = int(I[I_HEAD])
    if store:
        b.rho[head] = float(R(1) / np.maximum(sy, F[F_TINY]))
        b.hist[0, head].copy_(s)
        b.hist[1, head].copy_(y)
        I[I_HEAD] = (head + 1) % m
        I[I_COUNT] = min(int(I[I_COUNT]) + 1, m)
        F[F_GAMMA] = sy / np.maximum(yy, F[F_TINY])
        I[I_BRANCHES] |= BRANCHES["stored"]
    elif ok:
        I[I_BRANCHES] |= BRANCHES["curvature_skip"]
    f_old = F[F_F]
    if ok:
        F[F_F] = F[F_F_BEST]
        x.copy_(xn)
        g.copy_(gb)
    f = F[F_F]
    g_small = _scalar(g.abs().max()) <= F[F_GTOL]  # SciPy's stopping rules
    f_flat = ok and (f_old - f) <= F[F_FTOL] * np.maximum(np.maximum(abs(f_old), abs(f)), R(1))
    converged = bool(g_small or f_flat)
    I[I_K] += 1
    I[I_EVALS] += I[I_LS_EVALS]
    I[I_CONVERGED] = converged
    if converged or I[I_K] >= I[I_MAX_ITERS] or not ok:
        I[I_DONE] = 1
    else:
        I[I_NEED_DIR] = 1
    _store(b, I, F)


def direction_reference(b: Buffers) -> None:
    """The direction kernel in plain PyTorch: at an iteration's start the
    two-loop direction, the descent guard, the first step, the search's
    initial state and the trial point; see
    ``csrc/lbfgs.cu::direction_kernel``."""
    I, F = _load(b)
    if I[I_DONE] or not I[I_NEED_DIR]:
        return
    x, g, d, xt, gt, gb = b.vec
    count = int(I[I_COUNT])
    d.copy_(two_loop_reference(g, b.hist[0], b.hist[1], b.rho, count, int(I[I_HEAD]),
                               F[F_GAMMA]))
    R = F.dtype.type
    dg = _scalar(block_dot_reference(d, g))
    guard = not dg < 0  # not a descent direction: steepest descent
    if guard:
        d.copy_(-g)
        dg = _scalar(block_dot_reference(g, d))
        I[I_BRANCHES] |= BRANCHES["descent_guard"]
    if count == 0:
        gsum = _scalar(block_sum_reference(g.abs()))
        init = np.minimum(R(1), R(1) / np.maximum(gsum, F[F_EPS_STEP]))
    else:
        init = R(1)
    f = F[F_F]
    F[F_DPHI0] = dg
    F[F_A_LO], F[F_PHI_LO], F[F_DPHI_LO] = 0, f, dg
    F[F_A_HI], F[F_PHI_HI] = 0, f
    F[F_A_PREV], F[F_PHI_PREV], F[F_DPHI_PREV] = 0, f, dg
    F[F_A_TRIAL], F[F_A_BEST], F[F_F_BEST] = init, 0, f
    I[I_MODE] = I[I_LS_EVALS] = I[I_NEED_DIR] = 0
    I[I_STAGE] = STAGE_SEARCH
    gb.copy_(g)
    xt.copy_(x + _t(init, x) * d)
    _store(b, I, F)


# -- the kernels -----------------------------------------------------------------

def _lib():
    lib = build.load_library("lbfgs")
    if not getattr(lib, "_pinns_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pinns_lbfgs_slots.argtypes = [p, p, p, p]
        lib.pinns_lbfgs_slots.restype = i
        for suffix in ("", "_f64"):  # the float32 kernels and the float64 mode
            getattr(lib, f"pinns_lbfgs_direction_smem{suffix}").argtypes = [i, i, i]
            getattr(lib, f"pinns_lbfgs_direction_smem{suffix}").restype = ctypes.c_longlong
            getattr(lib, f"pinns_lbfgs_reset{suffix}").argtypes = [p, p, p, p, p, i, i, i, p,
                                                                     p]
            getattr(lib, f"pinns_lbfgs_reset{suffix}").restype = i
            getattr(lib, f"pinns_lbfgs_control{suffix}").argtypes = [p, p, p, p, p, p, i, i,
                                                                       ctypes.c_ulonglong, i, p]
            getattr(lib, f"pinns_lbfgs_control{suffix}").restype = i
            getattr(lib, f"pinns_lbfgs_direction{suffix}").argtypes = [p, p, p, p, p, i, i, i, i,
                                                                         p]
            getattr(lib, f"pinns_lbfgs_direction{suffix}").restype = i
        lib.pinns_lbfgs_loop_create.argtypes = [p, p]
        lib.pinns_lbfgs_loop_body.argtypes = [p, p]
        lib.pinns_lbfgs_loop_launch.argtypes = [p, p]
        lib.pinns_lbfgs_loop_destroy.argtypes = [p]
        for name in ("create", "body", "launch", "destroy"):
            getattr(lib, f"pinns_lbfgs_loop_{name}").restype = i
        lib.pinns_lbfgs_error_string.argtypes = [i]
        lib.pinns_lbfgs_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int() for _ in range(4)]
        lib.pinns_lbfgs_slots(*(ctypes.byref(v) for v in got))
        want = (N_INTS, N_FLOATS, N_ROWS, THREADS)
        if tuple(v.value for v in got) != want:
            raise RuntimeError(f"lbfgs.cu slots {[v.value for v in got]} != the wrapper's "
                               f"{list(want)}")
        lib._pinns_typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().pinns_lbfgs_error_string(err).decode()
        raise RuntimeError(f"K10 {what} launch failed: error {err} ({msg})")


def _stream(b: Buffers) -> int:
    return torch.cuda.current_stream(b.si.device).cuda_stream


def _ptrs(b: Buffers):
    return b.si.data_ptr(), b.sf.data_ptr(), b.vec.data_ptr(), b.hist.data_ptr(), b.rho.data_ptr()


def _entry(b: Buffers, name: str):
    """The library's entry point ``name`` for the solve's dtype (the
    float64 mode's carry ``_f64``)."""
    return getattr(_lib(), name + ("_f64" if b.dtype == torch.float64 else ""))


def solve_constants(c1: float = 1e-4, c2: float = 0.9, ftol: float = 1e-7, gtol: float = 1e-5,
                    dtype=np.float32) -> np.ndarray:
    """The constants a reset writes, rounded to ``dtype`` (float32, or
    float64 for the float64 mode): c1, c2, ftol, gtol, CONSTANTS."""
    return np.asarray((c1, c2, ftol, gtol) + CONSTANTS, dtype)


def _launch_reset(b: Buffers, x0: Optional[torch.Tensor], max_iters: int, max_ls: int,
                  consts: np.ndarray) -> None:
    """The reset kernel; x0 None resets in place (a null pointer)."""
    si, sf, vec, _, _ = _ptrs(b)
    consts = np.ascontiguousarray(consts, _np_dtype(b))
    _raise_on(_entry(b, "pinns_lbfgs_reset")(si, sf, vec, b.steps.data_ptr(),
                                             0 if x0 is None else x0.data_ptr(), b.n,
                                             int(max_iters), int(max_ls), consts.ctypes.data,
                                             _stream(b)), "reset")


def _launch_control(b: Buffers, cond: Optional[int] = None) -> None:
    """The control kernel; ``cond`` the condition of the WHILE node whose
    body it is captured into (:class:`SolveLoop`), which it sets to 0 at the
    solve's end."""
    _raise_on(_entry(b, "pinns_lbfgs_control")(*_ptrs(b), b.steps.data_ptr(), b.n, b.m,
                                               cond or 0, int(cond is not None), _stream(b)),
              "control")


def _launch_direction(b: Buffers, launch_only: bool = False,
                      plan: Optional[ClusterPlan] = None) -> None:
    """The direction kernel on ``plan`` (``cluster_plan(n, m)`` by default);
    ``launch_only`` inside a stream capture. The library's count of the
    plan's shared memory must be the wrapper's."""
    plan = cluster_plan(b.n, b.m, b.dtype.itemsize) if plan is None else plan
    got = _entry(b, "pinns_lbfgs_direction_smem")(b.n, b.m, int(plan.resident))
    if got != plan.smem:
        raise RuntimeError(f"lbfgs.cu counts {got} bytes of shared memory for {plan}")
    _raise_on(_entry(b, "pinns_lbfgs_direction")(*_ptrs(b), b.n, b.m, int(plan.resident),
                                                 int(launch_only), _stream(b)), "direction")


def reset(b: Buffers, x0: Optional[torch.Tensor], *, max_iters: int, max_ls: int = 50,
          c1: float = 1e-4, c2: float = 0.9, ftol: float = 1e-7, gtol: float = 1e-5) -> None:
    """A solve's initial state from ``x0`` (n,) in the buffers' dtype: the
    trial point is x0, the first step takes its evaluation. ``x0`` None
    resets in place: the next solve starts from the iterate ``vec[X]`` the
    last one left (no copy of it). Plain on CPU tensors."""
    global RESET_LAUNCHES, RESET_F64_LAUNCHES
    b.check()
    if x0 is not None and (tuple(x0.shape) != (b.n,) or x0.dtype != b.dtype
                           or x0.device != b.si.device or not x0.is_contiguous()):
        raise ValueError(f"K10: x0 must be contiguous {b.dtype} ({b.n},) on {b.si.device}")
    consts = solve_constants(c1, c2, ftol, gtol, _np_dtype(b))
    if b.si.device.type == "cpu":
        reset_reference(b, x0, max_iters, max_ls, consts)
        return
    _launch_reset(b, x0, max_iters, max_ls, consts)
    with _lock:
        if b.dtype == torch.float64:
            RESET_F64_LAUNCHES += 1
        else:
            RESET_LAUNCHES += 1


def control(b: Buffers) -> None:
    """The control kernel (``csrc/lbfgs.cu``); plain on CPU tensors."""
    global CONTROL_LAUNCHES, CONTROL_F64_LAUNCHES
    b.check()
    if b.si.device.type == "cpu":
        control_reference(b)
        return
    _launch_control(b)
    with _lock:
        if b.dtype == torch.float64:
            CONTROL_F64_LAUNCHES += 1
        else:
            CONTROL_LAUNCHES += 1


def direction(b: Buffers) -> None:
    """The direction kernel (``csrc/lbfgs.cu``); plain on CPU tensors."""
    global DIRECTION_LAUNCHES, DIRECTION_F64_LAUNCHES
    b.check()
    if b.si.device.type == "cpu":
        direction_reference(b)
        return
    _launch_direction(b)
    with _lock:
        if b.dtype == torch.float64:
            DIRECTION_F64_LAUNCHES += 1
        else:
            DIRECTION_LAUNCHES += 1


# -- the solve -------------------------------------------------------------------

# the head's entry after si[:4]: the step counter (Buffers.steps)
HEAD_STEPS = 4


def read_head(b: Buffers) -> np.ndarray:
    """si[:4] (done, converged, k, evals) and the step counter
    (``HEAD_STEPS``) on the host in one read: the solve's one kind of device
    read, counted in ``opt.lbfgs.HOST_SYNCS``."""
    host_lbfgs.HOST_SYNCS += 1
    return torch.cat((b.si[:4], b.steps)).cpu().numpy()


def result(b: Buffers, head: np.ndarray) -> host_lbfgs.LBFGSResult:
    """The solve's result from its buffers (tensors of the caller's own)."""
    return host_lbfgs.LBFGSResult(
        x=b.vec[X].clone(), f=b.sf[F_F].clone(), g=b.vec[G].clone(), n_iters=int(head[I_K]),
        n_evals=int(head[I_EVALS]), converged=bool(head[I_CONVERGED]))


def run_steps(b: Buffers, evaluate: Callable[[], None],
              sync_every: int = SYNC_EVERY) -> host_lbfgs.LBFGSResult:
    """The stepwise drive: evaluation steps (``evaluate``, control,
    direction) from a reset state, ``sync_every`` at a time between reads of
    the done flag, each step through the wrappers (the plain versions on the
    CPU). The card's checks hold :class:`SolveLoop` to it."""
    if sync_every < 1:
        raise ValueError(f"K10: sync_every = {sync_every}")
    while True:
        for _ in range(sync_every):
            evaluate()
            control(b)
            direction(b)
        head = read_head(b)
        if head[I_DONE]:
            return result(b, head)


def loop_reference(b: Buffers, evaluate: Callable[[], None], steps: int) -> None:
    """The WHILE node's plain drive: the condition 1 at the launch, then body
    iterations of ``steps`` evaluation steps (``evaluate``, the control and
    direction plain versions) while it holds; the control's plain version
    sets it to 0 where the kernel does. No read of the done flag."""
    cond = [1]
    while cond[0]:
        for _ in range(steps):
            evaluate()
            control_reference(b, cond)
            direction_reference(b)


# the graphs of loops that were dropped, destroyed at the next capture's
# start: a graph destroyed while a stream is capturing (the garbage
# collector runs at any allocation) invalidates that capture
_DROPPED: List[Tuple[int, object]] = []


def _drop(loop: int, graph) -> None:
    _DROPPED.append((loop, graph))


def _destroy_dropped() -> None:
    while _DROPPED:
        loop, graph = _DROPPED.pop()
        _raise_on(_lib().pinns_lbfgs_loop_destroy(loop), "loop destroy")
        del graph


class SolveLoop:
    """A solve as one launch: the port of ``lbfgs_minimize``'s
    ``lax.while_loop`` (``pinns_tpu/opt/lbfgs.py:306``). ``steps`` (k)
    evaluation steps (``evaluate(launch_only)``, the control kernel, the
    direction kernel) are the body of a conditional WHILE node
    (``csrc/lbfgs.cu``: ``pinns_lbfgs_loop_*``), whose condition every
    launch sets to 1 and the control launch that sets the done flag sets to
    0: from a reset state one launch runs the whole solve, ceil(n_evals / k)
    body iterations, with no read of the device.

    The graph is built by hand around a body captured by torch
    (``torch.cuda.graph`` into a ``CUDAGraph(keep_graph=True)``, so its
    scratch lives in that graph's memory pool, kept as long as the loop and
    destroyed, once the loop is dropped, at the next capture's start):
    the loop's graph and condition are made first, the body's control
    launches take the condition, and a copy of the captured graph becomes
    the node's body. The caller warms the evaluation up before (every
    kernel's set-up outside capture). The kernel launches the capture made
    are taken back from their counters and added per body iteration by
    :meth:`count`; the K10 kernels' counters take one launch a step.

    On CPU tensors the same steps run on the plain versions
    (:func:`loop_reference`). A build, capture or launch that fails raises.
    """

    def __init__(self, b: Buffers, evaluate: Callable[[bool], None], steps: int,
                 counted: Tuple[Tuple[object, str], ...] = ()):
        if steps < 1:
            raise ValueError(f"K10: a loop body of {steps} steps")
        self.b, self.evaluate, self.steps, self.counted = b, evaluate, steps, counted
        self.launches: Dict[Tuple[object, str], int] = {}  # a body iteration's, by counter
        self.collectives: Dict[str, int] = {}  # a body iteration's, by kind
        self.loop: Optional[int] = None
        if b.si.device.type == "cuda":
            self._capture()

    def _capture_steps(self, cond: Optional[int], keep_graph: bool):
        """The ``steps`` evaluation steps captured by torch (the control
        launches with the loop's condition ``cond``, or none); the kernel
        launches and collectives the capture counted are taken back and kept
        as a body's (:meth:`count` adds them for each body run)."""
        from pinns_tpu_torch.ops.kernels.generic_chunk import _kernel_counters

        b = self.b
        counters = _kernel_counters()  # the evaluation's kernels' counters
        before = {c: getattr(*c) for c in counters}
        coll = sharding.collective_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with torch.cuda.graph(graph):
            for _ in range(self.steps):
                self.evaluate(True)
                _launch_control(b, cond)
                _launch_direction(b, launch_only=True)
        self.launches = {c: getattr(*c) - before[c] for c in counters if getattr(*c) != before[c]}
        for (m, name), v in before.items():
            setattr(m, name, v)
        self.collectives = {k: v - coll.get(k, 0) for k, v in sharding.collective_counts().items()
                            if v != coll.get(k, 0)}
        for kind, v in self.collectives.items():
            sharding.count(kind, -v)
        return graph

    def _capture(self) -> None:
        lib, b = _lib(), self.b
        _destroy_dropped()
        loop, cond = ctypes.c_void_p(), ctypes.c_ulonglong()
        with torch.cuda.device(b.si.device):
            _raise_on(lib.pinns_lbfgs_loop_create(ctypes.byref(loop), ctypes.byref(cond)),
                      "loop graph")
        self.loop = loop.value
        graph = self._capture_steps(cond.value, keep_graph=True)
        _raise_on(lib.pinns_lbfgs_loop_body(self.loop, graph.raw_cuda_graph()), "loop body")
        # the body's pool lives as long as the loop; both are destroyed at the
        # next capture's start after the loop is dropped
        weakref.finalize(self, _drop, self.loop, graph).atexit = False
        self.evaluate = None  # no cycle through the caller's solver: dropped when it is

    def launch(self) -> None:
        """The solve from the buffers' reset state: one graph launch on the
        current stream (on the CPU the plain drive), uncounted."""
        if self.loop is None:
            loop_reference(self.b, lambda: self.evaluate(False), self.steps)
            return
        _raise_on(_lib().pinns_lbfgs_loop_launch(self.loop, _stream(self.b)), "loop")

    def run(self) -> np.ndarray:
        """One solve: :meth:`launch`, then the head read (the one host
        sync), and the launch counted from the device's step counter."""
        self.launch()
        head = read_head(self.b)
        self.count(int(head[HEAD_STEPS]), int(head[I_EVALS]))
        return head

    def count(self, steps: int, evals: int, launches: int = 1) -> None:
        """Count ``launches`` launches of the loop on the card that ran
        ``steps`` steps (the control kernel's count: body iterations x k)
        for ``evals`` evaluations."""
        global LOOP_LAUNCHES, LOOP_STEPS, STEPS_AFTER_END
        global CONTROL_LAUNCHES, DIRECTION_LAUNCHES, CONTROL_F64_LAUNCHES, DIRECTION_F64_LAUNCHES
        if self.b.si.device.type != "cuda":
            return
        if steps % self.steps or steps < evals:
            raise RuntimeError(f"K10: the device counted {steps} steps for {evals} evaluations "
                               f"in bodies of {self.steps}")
        bodies = steps // self.steps
        with _lock:
            LOOP_LAUNCHES += launches
            LOOP_STEPS += steps
            STEPS_AFTER_END += steps - evals
            if self.b.dtype == torch.float64:
                CONTROL_F64_LAUNCHES += steps
                DIRECTION_F64_LAUNCHES += steps
            else:
                CONTROL_LAUNCHES += steps
                DIRECTION_LAUNCHES += steps
            for (m, name), v in self.launches.items():
                setattr(m, name, getattr(m, name) + v * bodies)
            for m, name in self.counted:
                setattr(m, name, getattr(m, name) + steps)
        for kind, v in self.collectives.items():
            sharding.count(kind, v * bodies)


class SolveReplay(SolveLoop):
    """The sharded solve's drive, chosen by configuration (``problem.shard``,
    data parallelism): NCCL's captured all-reduce does not go into the body
    of a conditional node (``pinns_lbfgs_loop_body``: invalid argument on 2
    and 4 H100s), so ``steps`` = SYNC_EVERY evaluation steps are captured as
    a plain CUDA graph and replayed from a reset state, the done flag read
    after each replay (one host sync a replay, up to SYNC_EVERY - 1 steps
    after the end; counted in ``SHARD_REPLAYS``). Every rank takes the same
    decisions, so every rank replays as often. On CPU tensors the steps run
    on the plain versions."""

    def __init__(self, b: Buffers, evaluate: Callable[[bool], None],
                 counted: Tuple[Tuple[object, str], ...] = ()):
        super().__init__(b, evaluate, SYNC_EVERY, counted)

    def _capture(self) -> None:
        self.graph = self._capture_steps(None, keep_graph=False)
        self.evaluate = None

    def launch(self) -> None:
        raise RuntimeError("K10: a sharded solve replays its steps until the done flag is set "
                           "(SolveReplay.run); it has no single launch")

    def run(self) -> np.ndarray:
        global SHARD_REPLAYS
        if self.b.si.device.type != "cuda":
            loop_reference(self.b, lambda: self.evaluate(False), self.steps)
            return read_head(self.b)
        replays = 0
        while True:
            self.graph.replay()
            replays += 1
            head = read_head(self.b)
            if head[I_DONE]:
                break
        with _lock:
            SHARD_REPLAYS += replays
        self.count(int(head[HEAD_STEPS]), int(head[I_EVALS]), launches=0)
        return head


class AutogradLBFGS:
    """K10 over any float32 or float64 function of a flat vector, its
    gradient by torch.autograd: ``opt.lbfgs.lbfgs_minimize``'s contract on
    the reset, control and direction kernels (their plain versions on CPU
    tensors; a float64 ``x0`` takes the kernels' float64 mode). The trainer
    takes it on the card for every float32 L-BFGS phase outside
    :func:`lbfgs_device_supported` (the Euler branch, ``burgers_inverse``,
    the 8x200 nets) and for every float64 one (``polish``), the evaluation
    being autograd through the loss over the kernels it runs.

    An evaluation reads the trial point ``vec[XT]`` and writes ``vec[GT]``
    and ``sf[F_PHI_T]`` by device copies, with no read of the device; once
    the done flag is set its writes select the old values (``torch.where``
    on the flag), so steps after the end leave every buffer as it was.

    ``captured`` (the default): each solve captures ``steps`` (k) evaluation
    steps as a :class:`SolveLoop` around ``fun`` (after one warm-up
    evaluation with the done flag set, on a side stream) and runs as one
    launch of it, one read of the device a solve; the capture is made anew
    for every solve, since ``fun`` and the tensors it closes over change
    from one to the next. ``captured=False`` is the host-stepped drive
    (:func:`run_steps`, the flag read once every ``sync_every`` steps): the
    card's checks, and the configurations whose evaluation cannot be
    captured (:func:`autograd_capture_refusals`). On the CPU the captured
    solve runs the loop's plain drive. The buffers are kept for the next
    solve of the same (n, history)."""

    def __init__(self, sync_every: int = SYNC_EVERY, captured: bool = True,
                 steps: Optional[int] = None):
        self.sync_every, self.captured = sync_every, captured
        self.steps = AUTOGRAD_STEPS if steps is None else steps
        self.bufs: Optional[Buffers] = None
        self.loop: Optional[SolveLoop] = None
        self.capture_seconds: List[float] = []

    def _evaluate(self, fun: Callable[[torch.Tensor], torch.Tensor]) -> None:
        b = self.bufs
        with torch.enable_grad():
            x = b.vec[XT].clone().requires_grad_(True)
            f = fun(x)
            (g,) = torch.autograd.grad(f, x)
        with torch.no_grad():
            done = b.si[I_DONE] != 0
            b.sf[F_PHI_T:F_PHI_T + 1].copy_(
                torch.where(done, b.sf[F_PHI_T], f.detach().to(b.dtype)).reshape(1))
            b.vec[GT].copy_(torch.where(done, b.vec[GT], g))

    def _capture(self, fun: Callable[[torch.Tensor], torch.Tensor]) -> SolveLoop:
        """The solve's loop around ``fun``: on the card a warm-up evaluation
        and the kernels' set-up launches with the done flag set (they write
        nothing), on a side stream, then the capture."""
        b = self.bufs
        evaluate = lambda launch_only: self._evaluate(fun)  # noqa: E731
        if b.si.device.type != "cuda":
            return SolveLoop(b, evaluate, self.steps)
        t0 = time.perf_counter()
        b.si[I_DONE] = 1
        cur = torch.cuda.current_stream(b.si.device)
        side = torch.cuda.Stream(b.si.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._evaluate(fun)
            _launch_control(b)
            _launch_direction(b)
        cur.wait_stream(side)
        self.loop = None  # the last solve's graph and pool go first
        loop = SolveLoop(b, evaluate, self.steps)
        self.capture_seconds.append(time.perf_counter() - t0)
        return loop

    def minimize(self, fun: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                 max_iters: int = 5000, history: int = 50, ftol: float = 1e-7,
                 gtol: float = 1e-5, max_ls: int = 50, c1: float = 1e-4,
                 c2: float = 0.9) -> host_lbfgs.LBFGSResult:
        """Minimize ``fun`` from the flat float32 or float64 ``x0``; returns
        ``opt.lbfgs.LBFGSResult`` with tensors of the caller's own."""
        global SOLVES
        n = x0.shape[0]
        if x0.dtype not in DTYPES:
            raise ValueError(f"K10 solves in float32 or float64, got x0 of {x0.dtype}")
        b = self.bufs
        if b is None or (b.n, b.m, b.si.device, b.dtype) != (n, history, x0.device, x0.dtype):
            self.loop = None
            self.bufs = Buffers.alloc(n, history, x0.device, x0.dtype)
        opts = dict(max_iters=max_iters, max_ls=max_ls, c1=c1, c2=c2, ftol=ftol, gtol=gtol)
        if self.captured:
            self.loop = self._capture(fun)
            reset(self.bufs, x0.detach().contiguous(), **opts)
            res = result(self.bufs, self.loop.run())
        else:
            reset(self.bufs, x0.detach().contiguous(), **opts)
            res = run_steps(self.bufs, lambda: self._evaluate(fun), self.sync_every)
        if x0.device.type == "cuda":
            with _lock:
                SOLVES += 1
        return res


HOST_STEPPED_NOTE = ("K10: this L-BFGS phase's evaluation is not captured into the solve's "
                     "loop (AutogradLBFGS's host-stepped drive, the done flag read once every "
                     f"{SYNC_EVERY} steps): ")


def autograd_capture_refusals(problem) -> List[str]:
    """Why ``problem``'s L-BFGS evaluation stays on AutogradLBFGS's
    host-stepped drive on the card (empty when its solve is a captured
    :class:`SolveLoop`): decided from the configuration, never after a
    failure; the trainer prints them after :data:`HOST_STEPPED_NOTE`."""
    return ["data parallelism (the objective's NCCL all-reduce, parallel.sharding."
            "global_objective, does not go into the body of the solve's conditional WHILE "
            "node: the graph is refused as an invalid argument on 2 and 4 H100s)"
            ] if problem.shard is not None else []


class DeviceLBFGS:
    """K10 for one problem inside :func:`lbfgs_device_supported`: the loss
    ``make_loss_fn(problem)(params, colloc, admm, rho)[0]`` minimized over
    the flat params (``ravel_tree`` order, the frozen coefficients included
    with a zero gradient), its value-and-grad K3's
    (``fused_step.fused_value_and_grad``) at the net part of the trial
    point.

    On the card: the solve's buffers and a copy of the batch, z and dual are
    allocated once per shape; a :class:`SolveLoop` of ``steps`` (k)
    evaluation steps (K3's two launches, control, direction) is captured
    once per (rho, shape), after a warm-up of the same launches with the
    done flag set (the kernels' set-up, outside capture). A solve resets the
    state (one launch), launches the loop once and reads si[:4] once. On the
    CPU the same steps run as the plain versions (the loop's plain drive).
    A build, capture or launch that fails raises, and so does a cluster the
    card cannot place (checked by ``cudaOccupancyMaxActiveClusters`` in the
    warm-up).

    Under data parallelism (``problem.shard``, slice 6) an evaluation is K3's
    value-and-grad split around an all-reduce: the reduce mode over this
    rank's rows, the all-reduce of its sums over the data row, the apply
    mode's loss and gradient of the whole batch. The all-reduce does not go
    into a conditional node's body, so a sharded solve is a
    :class:`SolveReplay` (SYNC_EVERY steps with the all-reduce captured as
    a plain graph, replayed until the done flag is read set), chosen by the
    configuration and named by ``train.trainer.DP_LBFGS_NOTE``. Every rank's
    control and direction kernels see the same values and take the same
    branches, so every rank replays as often.
    """

    def __init__(self, problem, steps: Optional[int] = None):
        exp, spec = problem.exp, problem.spec
        why = lbfgs_device_supported(exp, spec)
        if why:
            raise NotImplementedError(
                f"experiment {exp.name!r} is outside K10's scope ({'; '.join(why)}); "
                "train.trainer.make_lbfgs_step runs the host loop for it")
        self.exp, self.spec, self.device = exp, spec, problem.device
        self.steps = DEVICE_STEPS if steps is None else steps
        self.cfg = k_fused.loss_config(exp)
        self.x_data = problem.x_data
        self.u_data = problem.targets["u"].contiguous()
        self.shape: Optional[Tuple[int, int, int, int]] = None
        self.loops: Dict[float, SolveLoop] = {}
        self.capture_seconds: List[float] = []
        self.shard = problem.shard
        self.sums = None

    def _alloc(self, n: int, m: int, n_f: int, offset: int) -> None:
        dev = self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        self.bufs = Buffers.alloc(n, m, dev)
        admm = self.cfg["kind"] == "admm"
        self.colloc = z(n_f, 2)
        self.z = z(n_f, 1) if admm else None
        self.dual = z(n_f, 1) if admm else None
        plan = k_fused.step_plan(self.spec.layers, n_f, self.x_data.shape[0])
        self.partials = z(plan.blocks, self.spec.n_params + 1)
        if self.shard is not None:
            self.sums = torch.zeros(2 * self.spec.n_params + 3, dtype=torch.float64, device=dev)
        self.shape = (n, m, n_f, offset)
        self.loops.clear()

    def _evaluate(self, rho: float, launch_only: bool = False) -> None:
        """The step's value-and-grad at the trial point (uncounted: the
        loop counts it); under a shard its reduce mode, the all-reduce of
        the sums, its apply mode."""
        b, off = self.bufs, self.shape[3]
        args = (self.spec, b.vec[XT, off:], b.vec[GT, off:], b.sf[F_PHI_T:F_PHI_T + 1],
                self.x_data, self.u_data, self.colloc, self.z, self.dual)
        kw = dict(rho=rho, partials=self.partials, skip=b.si[I_DONE:I_DONE + 1],
                  launch_only=launch_only, **self.cfg)
        if self.shard is None:
            k_fused._value_and_grad_call(*args, **kw)
            return
        n_f = self.colloc.shape[0]
        dp = dict(sums=self.sums, n_f_all=n_f * self.shard.size,
                  row0=self.shard.rows(n_f * self.shard.size).start,
                  data_tiles=int(self.shard.owner))
        k_fused._value_and_grad_call(*args, dp=dict(dp, mode="reduce"), **kw)
        self.shard.all_reduce(self.sums[:2 * self.spec.n_params + 2])
        k_fused._value_and_grad_call(*args, dp=dict(dp, mode="apply"), **kw)

    def _capture(self, rho: float) -> SolveLoop:
        evaluate = lambda launch_only: self._evaluate(rho, launch_only)  # noqa: E731
        counted = ((k_fused, "VALUE_AND_GRAD_LAUNCHES"),)
        drive = (SolveLoop if self.shard is None else
                 lambda b, ev, steps, counted: SolveReplay(b, ev, counted))
        if self.device.type != "cuda":
            return drive(self.bufs, evaluate, self.steps, counted)
        t0 = time.perf_counter()
        b = self.bufs
        b.si.zero_()
        b.si[I_DONE] = 1  # the warm-up's launches return at once
        self._evaluate(rho)
        _launch_control(b)
        _launch_direction(b)  # sets the kernel up; raises if the cluster cannot be placed
        torch.cuda.synchronize(self.device)
        loop = drive(b, evaluate, self.steps, counted)
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t0)
        return loop

    def _shape(self, n: int, m: int, n_f: int, offset: int) -> None:
        """The buffers for a solve of this shape (allocated anew, and the
        loops captured anew, when it changes)."""
        if n - offset != self.spec.n_params:
            raise ValueError(f"K10: {n} params with the net from {offset}: the net has "
                             f"{self.spec.n_params}")
        if self.shape != (n, m, n_f, offset):
            self._alloc(n, m, n_f, offset)

    def solve_loop(self, rho: float) -> SolveLoop:
        """The solve's loop at ADMM weight ``rho`` (float32), captured at
        first use."""
        if rho not in self.loops:
            self.loops[rho] = self._capture(rho)
        return self.loops[rho]

    def minimize(self, x0: torch.Tensor, offset: int, colloc: torch.Tensor, admm, rho: float, *,
                 max_iters: int, history: int = 50, ftol: float = 1e-7, gtol: float = 1e-5,
                 max_ls: int = 50) -> host_lbfgs.LBFGSResult:
        """Minimize from the flat ``x0`` (``ravel_tree`` order, the net from
        ``offset`` on: :func:`net_offset`) at the batch ``colloc`` and the
        ADMM state ``admm`` (None for another residual kind) with ADMM
        weight ``rho``. Returns ``opt.lbfgs.LBFGSResult`` with tensors of
        the caller's own."""
        global SOLVES
        if (admm is None) != (self.cfg["kind"] != "admm"):
            raise ValueError("K10: an ADMM state exactly when the residual kind is 'admm'")
        self._shape(x0.shape[0], history, colloc.shape[0], offset)
        b = self.bufs
        self.colloc.copy_(colloc)
        if admm is not None:
            self.z.copy_(admm.z)
            self.dual.copy_(admm.dual)
        loop = self.solve_loop(float(np.float32(rho)))  # first: the warm-up writes the buffers
        reset(b, x0.detach().contiguous(), max_iters=max_iters, max_ls=max_ls, ftol=ftol,
              gtol=gtol)
        head = loop.run()
        if self.device.type == "cuda":
            with _lock:
                SOLVES += 1
        return result(b, head)


# the sampling strategies whose next batch K3's post-update mode makes: the
# uniform Philox draw, or a fixed batch kept as it is
CHUNK_STRATEGIES = ("resample_uniform", "fixed_uniform", "fixed_lhs", "fixed_lhs_anchored")


def lbfgs_chunk_supported(exp, spec: MLPSpec) -> List[str]:
    """Why ``exp``'s L-BFGS phase cannot run as :class:`LBFGSChunk`'s
    chunks (empty when it can): K10's scope (:func:`lbfgs_device_supported`)
    and a next batch that K3's post-update mode makes (the uniform draw over
    the whole domain, or a fixed batch)."""
    out = lbfgs_device_supported(exp, spec)
    s = exp.sampling
    if s.strategy not in CHUNK_STRATEGIES:
        out.append(f"sampling.strategy={s.strategy!r} (K3's post-update draws uniformly or "
                   "keeps a fixed batch)")
    if s.t_curriculum_epochs > 0:
        out.append("the time curriculum (K3's post-update draws over the whole domain)")
    return out


class LBFGSChunk:
    """K10's outer epochs as chunks on the card: the port of JAX's
    ``make_chunked(make_lbfgs_step)`` (``pinns_tpu/train/trainer.py:835``
    over ``:724``) for a configuration inside :func:`lbfgs_chunk_supported`.

    An outer epoch is a whole solve at the current batch and ADMM state
    (one launch of :class:`DeviceLBFGS`'s :class:`SolveLoop`, which the
    control kernel ends), then the *post-update graph*: the solve's
    evaluations and steps added to a device tally, K3's post-update mode
    (``fused_step.fused_post_update``: the next batch, z and dual written in
    place into the buffers the loop reads, the data term and the metrics row
    at a device cursor) and the reset in place for the next outer epoch (its
    x0 is this solve's iterate, ``vec[X]``). A chunk enqueues its outer
    epochs' two launches each with no read of the device; the tally is read
    once after the chunk (for the counters), and ``lbfgs_iters`` is in the
    metrics rows.

    Allocated once per (n, history, N_f) (with the solver's buffers): a
    one-row member table (the seed, rho and the threshold, copied in per
    chunk, so one graph serves every seed and rho), a schedule of
    ``max_len`` rows of Philox epoch words (``fused_step.chunk_schedule``),
    ``max_len`` metrics rows, the tail's scratch and a cursor; the fed points
    (``new_colloc``) take rows of their own and a second post-update graph.
    :meth:`run` ravels the state once, loads the batch, z, dual and the
    rows, resets from x0, runs the outer epochs and hands the state back
    once, as tensors of the caller's own (the next chunk writes the
    buffers). On the CPU the same structure runs on the plain versions (the
    solve's steps, ``post_update_reference``, ``reset_reference`` in
    place), one host call each. A build, capture or launch that fails
    raises; nothing falls back.

    ``max_len`` (default ``train.chunk``) is the longest chunk it runs
    without allocating and capturing anew. Raises ``NotImplementedError``
    outside :func:`lbfgs_chunk_supported`.
    """

    def __init__(self, problem, max_len: Optional[int] = None):
        exp, spec = problem.exp, problem.spec
        why = lbfgs_chunk_supported(exp, spec)
        if why:
            raise NotImplementedError(
                f"experiment {exp.name!r} is outside K10's chunk scope ({'; '.join(why)}); "
                "train.trainer.make_lbfgs_step runs it an outer epoch a host call")
        self.exp, self.spec, self.device = exp, spec, problem.device
        self.solver = DeviceLBFGS(problem)
        self.cfg = k_fused.loss_config(exp)
        self.drawn = exp.sampling.strategy == "resample_uniform"
        lb = exp.optimizer.lbfgs
        self.history = lb.history
        self.opts = dict(max_iters=lb.max_iters, max_ls=lb.max_ls, ftol=lb.ftol, gtol=lb.gtol)
        self.consts = solve_constants(ftol=lb.ftol, gtol=lb.gtol)
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=self.device)
        self._zeros = zeros
        self.cursor = zeros(1, dtype=torch.int32)
        # the chunk's steps run inside the loop (the device's step counter)
        # and its evaluations, for the counters (SolveLoop.count), read once
        # after the chunk
        self.tally = zeros(2, dtype=torch.int32)
        self.table = zeros(1, 4, dtype=torch.int32)
        self.tail_partials: Optional[torch.Tensor] = None
        self.shape: Optional[Tuple[int, int, int]] = None
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.capture_seconds: List[float] = []
        self._rows(max(1, int(exp.train.chunk if max_len is None else max_len)))

    def _rows(self, n: int) -> None:
        """Schedule and metrics rows for chunks of up to ``n`` outer epochs
        (the graphs hold their addresses: capture anew)."""
        self.max_len = n
        self.sched = self._zeros(n, 4, dtype=torch.int32)
        self.metrics = self._zeros(n, 7)
        self.feed: Optional[torch.Tensor] = None
        self.graphs.clear()

    def _shape(self, n: int, n_f: int, offset: int) -> None:
        """The solver's buffers and the tail's scratch for this shape (the
        post-update graphs hold their addresses: capture anew)."""
        if self.shape == (n, n_f, offset):
            return
        self.solver._shape(n, self.history, n_f, offset)
        self.tail_partials = self._zeros(
            sum(k_fused.post_update_tail(self.spec.layers, n_f, self.solver.x_data.shape[0])))
        self.feed = None
        self.graphs.clear()
        self.shape = (n, n_f, offset)

    def _post(self, fed: bool, launch_only: bool) -> None:
        """The solve's tally, the post-update mode, then the reset in place
        (plain on the CPU; uncounted on the card: the replays are)."""
        s, b, off = self.solver, self.solver.bufs, self.shape[2]
        self.tally.add_(torch.cat([b.steps, b.si[I_EVALS:I_EVALS + 1]]))
        k_fused._post_update_call(
            self.spec, b.vec[X, off:], s.x_data, s.u_data, s.colloc, s.z, s.dual, self.metrics,
            self.cursor, self.sched, self.table, b.sf[F_F:F_F + 1], b.si[I_K:I_K + 1],
            kind=self.cfg["kind"], lam1=self.cfg["lam1"], lam2=self.cfg["lam2"],
            feed=self.feed if fed else None, fixed=not self.drawn,
            tail_partials=self.tail_partials, launch_only=launch_only)
        if self.device.type == "cpu":
            reset_reference(b, None, self.opts["max_iters"], self.opts["max_ls"], self.consts)
        else:
            _launch_reset(b, None, self.opts["max_iters"], self.opts["max_ls"], self.consts)

    def _capture(self, fed: bool) -> torch.cuda.CUDAGraph:
        t0 = time.perf_counter()
        self.cursor.zero_()
        self._post(fed, launch_only=False)  # the warm-up: the set-up, outside capture
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._post(fed, launch_only=True)
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t0)
        return graph

    def run(self, state, length: int, new_colloc: Optional[torch.Tensor] = None):
        """``length`` outer epochs from ``state``: (state, {metric: (length,)
        tensor}) as ``train.trainer.run_chunk`` of the L-BFGS step gives
        them. ``new_colloc`` (length, N_f, 2) replaces the Philox draws (a
        fixed batch ignores it, as the step does)."""
        global RESET_LAUNCHES, CHUNK_EPOCHS, SOLVES
        if length < 1:
            raise ValueError(f"K10: a chunk of {length} outer epochs")
        if length > self.max_len:
            self._rows(length)
        x0, unravel = host_lbfgs.ravel_tree(state.params)
        n_f = state.colloc.shape[0]
        self._shape(x0.numel(), n_f, net_offset(state.params))
        s, b = self.solver, self.solver.bufs
        if (state.admm is None) != (s.z is None):
            raise ValueError("K10: the state's ADMM state does not match the residual kind")
        fed = self.drawn and new_colloc is not None
        if fed and self.feed is None:
            self.feed = self._zeros(self.max_len, n_f, 2)
        rho = self.exp.loss.rho if state.rho is None else state.rho
        cuda = self.device.type == "cuda"
        loop = s.solve_loop(float(np.float32(rho)))  # first: the warm-ups write the buffers
        if cuda and fed not in self.graphs:
            self.graphs[fed] = self._capture(fed)
        s.colloc.copy_(state.colloc)
        if state.admm is not None:
            s.z.copy_(state.admm.z)
            s.dual.copy_(state.admm.dual)
        self.table.copy_(k_fused.member_table([state.key], [rho], n_f, self.device))
        # the Philox epoch words of each outer epoch (the schedule's bias
        # corrections are Adam's and unread here)
        sched = k_fused.chunk_schedule(0, int(state.epoch), length)
        self.sched[:length].copy_(torch.from_numpy(sched))
        if fed:
            self.feed[:length].copy_(new_colloc.reshape(length, n_f, 2))
        self.cursor.zero_()
        self.tally.zero_()
        reset(b, x0.contiguous(), **self.opts)
        for _ in range(length):
            loop.launch()
            if cuda:
                self.graphs[fed].replay()
            else:
                self._post(fed, launch_only=False)
        if cuda:
            host_lbfgs.HOST_SYNCS += 1
            steps, evals = self.tally.tolist()
            loop.count(steps, evals, launches=length)
            with _lock:
                RESET_LAUNCHES += length
                CHUNK_EPOCHS += length
                SOLVES += length
            with k_fused._launches_lock:
                k_fused.POST_UPDATE_LAUNCHES += length
        return self._hand_back(state, unravel, length)

    def _hand_back(self, state, unravel, length: int):
        from pinns_tpu_torch.losses.admm import ADMMState
        from pinns_tpu_torch.train.trainer import METRIC_KEYS

        s = self.solver
        metrics = self.metrics[:length].clone()
        new_state = state._replace(
            params=unravel(s.bufs.vec[X].clone()), colloc=s.colloc.clone(),
            admm=None if state.admm is None else ADMMState(z=s.z.clone(), dual=s.dual.clone()),
            epoch=state.epoch + length)
        return new_state, {k: metrics[:, i] for i, k in enumerate(METRIC_KEYS)}


def branches_taken(b: Buffers) -> List[str]:
    """The names of the branches a solve took (si[I_BRANCHES])."""
    bits = int(b.si[I_BRANCHES])
    return [name for name, bit in BRANCHES.items() if bits & bit]
