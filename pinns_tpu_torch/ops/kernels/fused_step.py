"""Wrapper of the fused Adam-epoch CUDA kernel (``csrc/fused_step.cu``), the
step factory the trainer uses on a CUDA device, and the kernel's algorithm in
plain PyTorch.

Replaces the TPU kernel ``make_fused_adam_step`` (``_step_kernel``;
``pinns_tpu/ops/pallas/fused_step.py`` at git ``3266821^``, lines 49-440):
one Adam epoch of a Burgers strong-form configuration, from the loss and its
gradient through Adam, resampling and the ADMM z/dual update to the metrics.
The plain version is the plain step ``train.trainer.make_adam_step``; the
CPU tests hold it against JAX and ``chip_smoke.py`` holds the kernel against
it on the card. ``loss_and_grad_reference`` is the kernel's hand-written
reverse mode in plain PyTorch, held against ``torch.autograd`` by the CPU
tests: the guard on the math the CUDA code implements.

Two designs, picked by :func:`design` from the widths (the header of
``csrc/fused_step.cu`` has both and what bounds them on the H100):

- "narrow", every width at most NARROW_WIDTH (``abgrall_admm``'s 8x20): four
  launches an epoch, blocks of 8-point tiles (138 at N_f 1,000 and N_u 100)
  that keep their points' streams in shared memory through the forward and
  the backward and write per-tile partial gradients, reduced in a fixed
  order (:func:`launch_config`);
- "wide", any wider net (``abgrall_l1/l2/visc``'s 8x200): the whole epoch as
  layer products on the engine of ``csrc/layer_gemm.cuh`` over one stacked
  batch of the collocation and data points, on a block tile that fills the
  card at the presets' 1,100 points (:func:`step_plan`);
  :func:`wide_loss_and_grad_reference` is its algorithm in plain PyTorch.

Both are bit-for-bit repeatable (no atomics).

K8, the member-batched narrow design (:func:`fused_adam_ensemble_step`): one
host call runs the four launches for E members of an ensemble at once, each
launch with the member as its grid's y index; every member has its own
params, Adam moments, batch, ADMM state, Philox seed and rho
(:func:`member_table`). A solo call is the same path with one member and no
table, so member m of a K8 call equals a solo call of member m bit for bit.
Its plain version is the per-member loop of the plain step.

K10's value-and-grad (:func:`fused_value_and_grad`): the narrow design's grad
kernel and the partials' sum alone, the loss and the gradient at given
params, for the L-BFGS solve on the device (``ops/kernels/lbfgs.py``). Its
plain version is :func:`value_and_grad_reference`, which it runs on CPU
tensors.

K3's post-update mode (:func:`fused_post_update`): the narrow design's tail
and finalize kernels alone, what follows one of K10's outer solves (the new
batch, z and dual written in place into the solve's buffers, the data term
from the same launches and the metrics row at a device cursor), for K10's
chunk of outer epochs (``ops/kernels/lbfgs.py::LBFGSChunk``). Its plain
version is :func:`post_update_reference`, which it runs on CPU tensors.

The epoch wrappers validate what the kernel assumes and raise otherwise; on
a CPU tensor they raise too. Nothing falls back to the plain step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves, taylor2_backward_reference
from pinns_tpu_torch.opt.adam import B1, B2, EPS, AdamState, bias_corrections

LAUNCHES = 0  # solo host calls (one per epoch) in this process; chip_smoke.py reads it
ENSEMBLE_LAUNCHES = 0  # K8's host calls (one per epoch for all members)
GRAPH_REPLAYS = 0  # K9: replays of a captured chunk graph (solo K3 or K8)
GRAPH_EPOCHS = 0  # K9: epochs run inside those replays (an epoch of all members counts one)
# K10: value-and-grad calls (two launches each): host calls, and those run
# inside the replays of K10's captured solve steps (ops/kernels/lbfgs.py)
VALUE_AND_GRAD_LAUNCHES = 0
# K3's post-update mode (tail and finalize, two launches each): host calls,
# and those run inside the replays of K10's chunk runner (LBFGSChunk)
POST_UPDATE_LAUNCHES = 0
_launches_lock = threading.Lock()

KINDS = {"admm": 0, "mean_sq": 1, "l2_sq_norm": 2, "l1_sq_norm": 3}
MAX_WIDTH = 256
MAX_LAYERS = 32
NARROW_WIDTH = 32  # a net whose widths are all at most this takes the narrow design
# the narrow design: a block of NARROW_THREADS threads holds a tile of at
# most NARROW_THREADS / NARROW_WIDTH = 8 points (its forward runs a thread
# for two units of a point, its backward loops over its items). The grad
# kernel takes the first of NARROW_TILES whose block fits SMEM_LIMIT (8
# points: 138 blocks at N_f 1,000 and N_u 100; 2 points fit the deepest net
# of MAX_LAYERS), the tail always TAIL_TILE (143 blocks at N_f 1,000, the
# largest tile with which the tail too fills the card's 132 SMs; its block
# fits every narrow net)
NARROW_THREADS = 256
NARROW_TILES = (8, 4, 2)
TAIL_TILE = 7
SMEM_LIMIT = 232_448  # a block's shared memory on sm_90 (227 KB)
# the wide design: each segment of the stacked batch (the collocation points,
# then the data points) padded to whole EW_TILE-point tiles (the point tile of
# the elementwise passes and of db's and the loss's per-tile sums); the
# products' block tile TILE (32 x 32, 64 threads); dW's sum over the stacked
# rows split into chunks of SPLIT_ROWS rows that never straddle the two
# segments, the longest for which the widest layer's dW still takes
# SPLIT_BLOCKS blocks. Each chunk's sum is one float32 chain, so shorter
# chunks are more accurate: at the presets' 1,100 points this target takes
# the shortest, 128 rows (scripts/k3_tile_sweep.py --f64 weighs the split in
# time and in error against float64)
EW_TILE = 32
TILE = 32
SPLIT_BLOCKS = 1600
SPLIT_ROWS = (1024, 512, 256, 128)
MAX_MEMBERS = 65_535  # K8: the member is the launches' grid y index
# argument slots, in the order of the enums in csrc/fused_step.cu
_PTRS = ("params", "mu", "nu", "x_data", "u_data", "colloc", "z", "dual", "new_colloc",
         "params_out", "mu_out", "nu_out", "colloc_out", "z_out", "dual_out", "metrics",
         "grad_out", "partials", "tail_partials", "scratch", "members", "cursor", "sched",
         "loss_out", "skip", "f_in", "iters_in")
_FLOATS = ("lb0", "lb1", "ub0", "ub1", "lam1", "lam2", "rho", "lr", "one_minus_b1", "b1",
           "one_minus_b2", "b2", "eps", "bc1", "bc2", "threshold")
_INTS = ("n_u", "n_f", "kind", "explicit_inner", "tile", "tail_tile", "seed", "epoch", "device",
         "nf_pad", "nu_pad", "split_rows", "splits", "scratch_floats", "n_members",
         "metrics_stride", "new_colloc_stride", "launch_only", "value_and_grad")


def fused_step_supported(exp, spec: MLPSpec) -> List[str]:
    """Why ``exp`` is outside the kernel's scope (empty when it is inside).

    The scope of the TPU kernel (``fused_step.py:49-76``) plus what that
    check left implicit: the strong form without entropy, gradient or causal
    weighting, one output, widths up to 256, and no input embedding (Fourier
    or shock-path features take the generic step over K1/K2 and K5; K3 with
    them is ROADMAP queue 2).
    """
    lo, s = exp.loss, exp.sampling
    reasons = [
        (exp.pde.kind != "burgers", f"pde.kind={exp.pde.kind!r}"),
        (exp.optimizer.lr_schedule != "constant", "a learning-rate schedule"),
        (exp.pde.train_coeffs, "trainable PDE coefficients"),
        (s.strategy != "resample_uniform", f"sampling.strategy={s.strategy!r}"),
        (s.microbatch > 1, "microbatching"),
        (s.t_curriculum_epochs > 0, "the time curriculum"),
        (lo.data_kind != "mse_sum", f"loss.data_kind={lo.data_kind!r}"),
        (lo.data_weight != 1.0 or lo.residual_weight != 1.0, "loss weights other than 1"),
        (lo.residual_kind not in KINDS, f"loss.residual_kind={lo.residual_kind!r}"),
        (lo.admm_update_points != "resampled", "admm_update_points='current'"),
        (lo.admm_form != "strong", "the weak-form ADMM residual"),
        (lo.entropy_weight > 0.0 or lo.grad_weight_kappa != 0.0 or lo.causal_eps > 0.0,
         "entropy, gradient or causal weighting"),
        (spec.dtype != torch.float32 or spec.mixed,
         "a dtype other than float32 (K3's float64 mode is left to a later slice: ROADMAP "
         "queue 2)"),
        (spec.n_paths > 0 or spec.fourier,
         "Fourier or shock-path features (K3 computes no input embedding: ROADMAP queue 2; "
         "the generic step takes them through K1/K2 and K5)"),
        (spec.in_dim != 2 or spec.out_dim != 1, f"widths {spec.layers} (needs 2 -> ... -> 1)"),
        (max(spec.layers) > MAX_WIDTH, f"a width above {MAX_WIDTH}"),
        (len(spec.layers) - 1 > MAX_LAYERS or len(spec.layers) < 3,
         f"{len(spec.layers) - 1} layers (needs 2 to {MAX_LAYERS})"),
    ]
    return [why for bad, why in reasons if bad]


def _n_params(layers: Sequence[int]) -> int:
    return sum(din * dout + dout for din, dout in zip(layers[:-1], layers[1:]))


def narrow_smem(layers: Sequence[int], tile: int, planes: int) -> int:
    """Bytes of a narrow block's shared memory (``narrow_smem`` in the
    kernel): the params, ``planes`` planes of max(layers) x (tile + 1)
    float4 (a layer's four streams; the padding keeps dW's reads off shared
    banks) and the tile's loss terms, each part on 16 bytes. The grad kernel
    takes 2 n_layers + 1 planes (every layer's input and pre-activation
    streams, two adjoint planes), the tail kernel 2."""
    return 4 * (_align4(_n_params(layers)) + 4 * max(layers) * (tile + 1) * planes
                + _align4(tile))


def launch_config(layers: Sequence[int]) -> Tuple[int, int]:
    """(grad-kernel tile, tail-kernel tile) in points per block: the narrow
    design, the first of NARROW_TILES whose block fits SMEM_LIMIT (0, which
    the kernel refuses, if none does) and TAIL_TILE."""
    planes = 2 * (len(layers) - 1) + 1
    tile = next((t for t in NARROW_TILES if narrow_smem(layers, t, planes) <= SMEM_LIMIT), 0)
    return tile, TAIL_TILE


def design(layers: Sequence[int]) -> str:
    """"narrow" or "wide": the K3 design that a net of these widths takes."""
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"fused_step kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    return "narrow" if wmax <= NARROW_WIDTH else "wide"


def _ld_h(width: int) -> int:
    """The row pitch of a stacked input of this width: its columns, the
    bias's indicator, padded to 4 floats (``ld_h`` in the kernel)."""
    return (width + 4) // 4 * 4


def _align4(floats: int) -> int:
    return -(-floats // 4) * 4


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """How an epoch launches. The narrow design: points a grad block
    (``tile``; ``blocks`` of them, the collocation tiles then the data tiles)
    and a tail block (``tail_tile``, ``tail_blocks``), each kernel's shared
    memory in bytes (``smem``, ``tail_smem``: :func:`narrow_smem`), and a
    member's scratch in floats: the tiles' partial gradients and loss sums
    (``partials``, blocks x (n_params + 1)) and the tail's sums of |f - z|
    (``tail_part``, tail_blocks); every other field 0. The wide design: each segment of the stacked batch padded (``nf_pad``
    collocation points, then ``nu_pad`` data points), the products' block
    ``tile``, dW's sum over the 4 (nf_pad + nu_pad) stacked rows cut into
    ``splits`` chunks of ``split_rows`` (the last one shorter; the first
    4 nf_pad / split_rows over collocation rows), and the parts of its
    float32 scratch (in floats, each rounded up to 16 bytes, in the kernel's
    order): db's per-tile sums, the loss's and the tail's per-tile sums (all
    doubles), the stacked input H_0, the pre-activations of every hidden
    layer, the stacked inputs of one layer, two adjoint buffers, the head's
    output, dW's split partials and the gradient. The kernel lays the scratch
    out itself and refuses a plan that does not fit it."""

    design: str
    tile: int
    tail_tile: int = 0
    blocks: int = 0
    tail_blocks: int = 0
    smem: int = 0
    tail_smem: int = 0
    nf_pad: int = 0
    nu_pad: int = 0
    split_rows: int = 0
    splits: int = 0
    sums: int = 0
    loss_part: int = 0
    tail_part: int = 0
    h0: int = 0
    pstore: int = 0
    hbuf: int = 0
    gbuf: int = 0
    head: int = 0
    partials: int = 0
    grad: int = 0

    @property
    def rows(self) -> int:
        """The stacked rows of the training pass: four streams a point."""
        return 4 * (self.nf_pad + self.nu_pad)

    @property
    def scratch_floats(self) -> int:
        return (self.sums + self.loss_part + self.tail_part + self.h0 + self.pstore + self.hbuf
                + self.gbuf + self.head + self.partials + self.grad)

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def _wide_plan(layers: Sequence[int], n_f: int, n_u: int) -> StepPlan:
    layers = tuple(int(w) for w in layers)
    nf_pad = max(1, -(-n_f // EW_TILE)) * EW_TILE
    nu_pad = max(1, -(-n_u // EW_TILE)) * EW_TILE
    n_pad = nf_pad + nu_pad
    rows = 4 * n_pad
    pairs = list(zip(layers[:-1], layers[1:]))
    pieces = max(-(-din // TILE) * -(-dout // TILE) for din, dout in pairs)
    fits = [r for r in SPLIT_ROWS if (4 * nf_pad) % r == 0]
    split_rows = next((r for r in fits if pieces * -(-rows // r) >= SPLIT_BLOCKS), fits[-1])
    splits = -(-rows // split_rows)
    n_params = _n_params(layers)
    tiles = n_pad // EW_TILE
    return StepPlan(
        design="wide", tile=TILE, nf_pad=nf_pad, nu_pad=nu_pad, split_rows=split_rows,
        splits=splits, sums=_align4(2 * (len(layers) - 1) * tiles * max(layers)),
        loss_part=_align4(2 * tiles), tail_part=_align4(2 * (nf_pad // EW_TILE)), h0=rows * 4,
        pstore=rows * sum(layers[1:-1]), hbuf=rows * _ld_h(max(layers)),
        gbuf=2 * rows * max(layers), head=rows, partials=_align4(splits * n_params),
        grad=_align4(n_params))


def step_plan(layers: Sequence[int], n_f: int, n_u: int) -> StepPlan:
    """The plan of an epoch of ``n_f`` collocation and ``n_u`` data points
    through a net of these widths (cached: the step asks for it every epoch)."""
    return _cached_plan(tuple(layers), n_f, n_u)


@functools.lru_cache(maxsize=64)
def _cached_plan(layers: Tuple[int, ...], n_f: int, n_u: int) -> StepPlan:
    if design(layers) == "narrow":
        tile, tail_tile = launch_config(layers)
        blocks, tail_blocks = -(-n_f // tile) + -(-n_u // tile), -(-n_f // tail_tile)
        return StepPlan(design="narrow", tile=tile, tail_tile=tail_tile, blocks=blocks,
                        tail_blocks=tail_blocks,
                        smem=narrow_smem(layers, tile, 2 * (len(layers) - 1) + 1),
                        tail_smem=narrow_smem(layers, tail_tile, 2),
                        partials=blocks * (_n_params(layers) + 1), tail_part=tail_blocks)
    return _wide_plan(layers, n_f, n_u)


def product_blocks(plan: StepPlan, layers: Sequence[int]) -> int:
    """Blocks of a wide plan's widest hidden-layer product over the stacked
    rows (the forward's P = H [W; b], and gH = G W^T of the backward)."""
    return -(-plan.rows // plan.tile) * -(-max(layers[1:-1]) // plan.tile)


def _lib():
    lib = build.load_library("fused_step")
    if not getattr(lib, "_pinns_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in (lib.pinns_fused_step, lib.pinns_fused_post_update):
            entry.argtypes = [p, i, p, p, p, p]
            entry.restype = i
        lib.pinns_fused_step_sizes.argtypes = [p, p, p]
        lib.pinns_fused_step_sizes.restype = i
        lib.pinns_fused_step_error_string.argtypes = [i]
        lib.pinns_fused_step_error_string.restype = ctypes.c_char_p
        sizes = [ctypes.c_int() for _ in range(3)]
        lib.pinns_fused_step_sizes(*(ctypes.byref(s) for s in sizes))
        want = (len(_PTRS), len(_FLOATS), len(_INTS))
        if tuple(s.value for s in sizes) != want:
            raise RuntimeError(f"fused_step.cu argument slots {[s.value for s in sizes]} "
                               f"!= the wrapper's {list(want)}")
        lib._pinns_typed = True
    return lib


def member_table(seeds: Sequence[int], rhos: Sequence[float], n_f: int,
                 device) -> torch.Tensor:
    """K8's per-member scalars as an (E, 4) int32 device table, one row a
    member: the Philox seed's low and high words, then rho and the prox
    threshold 1/(rho N_f) as float32 bits, each rounded as a solo call rounds
    them. Build it once per ensemble: it does not change between epochs."""
    if len(seeds) != len(rhos):
        raise ValueError(f"member_table: {len(seeds)} seeds but {len(rhos)} rhos")
    seed = np.asarray([int(v) & 0xFFFFFFFFFFFFFFFF for v in seeds], np.uint64)
    rho = np.asarray([float(v) for v in rhos], np.float64)
    tab = np.empty((len(seed), 4), np.uint32)
    tab[:, 0] = (seed & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tab[:, 1] = (seed >> np.uint64(32)).astype(np.uint32)
    tab[:, 2] = rho.astype(np.float32).view(np.uint32)
    tab[:, 3] = (1.0 / (rho * n_f)).astype(np.float32).view(np.uint32)
    return torch.from_numpy(tab.view(np.int32)).to(device)


def _scratch(plan: StepPlan, spec: MLPSpec, n_members: int,
             device) -> Dict[str, Optional[torch.Tensor]]:
    """The scratch of an epoch of ``n_members`` members under ``plan``."""
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)  # noqa: E731
    if plan.design == "narrow":
        return {"partials": empty(n_members, plan.blocks, spec.n_params + 1),
                "tail_partials": empty(n_members, plan.tail_blocks), "scratch": None}
    return {"partials": None, "tail_partials": None, "scratch": empty(plan.scratch_floats)}


def _epoch(spec: MLPSpec, n_members: int, params, mu, nu, count: int, x_data, u_data, colloc,
           z, dual, *, kind: str, lam1: float, lam2: float, rho: Optional[float], lr: float,
           explicit_inner: bool, seed: int, epoch: int, members=None, new_colloc=None,
           metrics_out=None, want_grad: bool = False, out=None, scratch=None, chunk=None,
           launch_only: bool = False) -> Dict[str, torch.Tensor]:
    """One host call of the CUDA step for ``n_members`` members, every
    per-member tensor with a leading member axis (the shared x_data and
    u_data without one). ``members`` (:func:`member_table`) gives each member
    its seed, rho and threshold (``rho`` is then None); without it (one
    member) ``seed`` and ``rho`` do. Validates, allocates the outputs and the
    scratch, launches; counts nothing (its callers do).

    K9 (:class:`FusedChunk`): ``out`` (params, mu, nu, colloc, z, dual) and
    ``scratch`` (:func:`_scratch`) are buffers to write in place of new
    tensors; ``chunk`` = (cursor, sched) makes every launch take the epoch
    from row ``cursor`` of ``sched`` (:func:`chunk_schedule`; ``count`` and
    ``epoch`` unused), write that row of ``metrics_out`` (rows, E, 7) and
    read that row of ``new_colloc`` (rows, E, N_f, 2), and advances the
    cursor; ``launch_only`` issues the launches alone, as a stream capture
    needs (an earlier call on the device made the set-up)."""
    dev = colloc.device
    layers = spec.layers
    n_params = spec.n_params
    E = n_members
    n_f, n_u = colloc.shape[-2], x_data.shape[0]
    rows = () if chunk is None else (chunk[1].shape[0],)
    if kind not in KINDS:
        raise ValueError(f"fused_step kernel: residual kind {kind!r} not in {sorted(KINDS)}")
    if (kind == "admm") != (z is not None and dual is not None):
        raise ValueError("fused_step kernel: z/dual are given exactly when kind == 'admm'")
    if spec.in_dim != 2 or spec.out_dim != 1 or max(layers) > MAX_WIDTH \
            or not 2 <= len(layers) - 1 <= MAX_LAYERS:
        raise ValueError(f"fused_step kernel: unsupported widths {layers}")
    if not 1 <= E <= MAX_MEMBERS:
        raise ValueError(f"fused_step kernel: {E} members (takes 1 to {MAX_MEMBERS})")
    if (E > 1 or members is not None) and design(layers) != "narrow":
        raise ValueError(f"fused_step kernel: the member-batched step (K8) is the narrow "
                         f"design's; widths {layers} take the wide one, one member a call")
    if (members is None) != (rho is not None):
        raise ValueError("fused_step kernel: a member table, or (one member) a rho")
    if E > 1 and members is None:
        raise ValueError("fused_step kernel: several members need a member table")
    if chunk is not None and (metrics_out is None or want_grad):
        raise ValueError("fused_step kernel: a chunk's epochs write their metrics rows and "
                         "no gradient")
    shapes = {"params": (params, (E, n_params)), "mu": (mu, (E, n_params)),
              "nu": (nu, (E, n_params)), "x_data": (x_data, (n_u, 2)),
              "u_data": (u_data, (n_u, 1)), "colloc": (colloc, (E, n_f, 2))}
    if z is not None:
        shapes.update(z=(z, (E, n_f, 1)), dual=(dual, (E, n_f, 1)))
    if new_colloc is not None:
        shapes["new_colloc"] = (new_colloc, rows + (E, n_f, 2))
    if metrics_out is not None:
        shapes["metrics_out"] = (metrics_out, rows + (E, 7))
    if out is not None:
        shapes.update({f"{k}_out": (out[k], shapes[k][1])
                       for k in ("params", "mu", "nu", "colloc")})
        if z is not None:
            shapes.update(z_out=(out["z"], (E, n_f, 1)), dual_out=(out["dual"], (E, n_f, 1)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"fused_step kernel: {name} must be contiguous float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if members is not None and (tuple(members.shape) != (E, 4) or members.dtype != torch.int32
                                or members.device != dev or not members.is_contiguous()):
        raise ValueError(f"fused_step kernel: the member table must be contiguous int32 "
                         f"({E}, 4) on {dev}, got {members.dtype} {tuple(members.shape)} "
                         f"on {members.device}")
    if chunk is not None:
        cursor, sched = chunk
        if tuple(cursor.shape) != (1,) or cursor.dtype != torch.int32 or cursor.device != dev \
                or sched.dim() != 2 or sched.shape[1] != 4 or sched.dtype != torch.int32 \
                or sched.device != dev or not sched.is_contiguous():
            raise ValueError("fused_step kernel: a chunk's cursor is one int32 and its "
                             f"schedule (rows, 4) int32, both on {dev}")
    if n_f < 1 or n_u < 1:
        raise ValueError("fused_step kernel needs at least one collocation and one data point")
    if dev.type != "cuda":
        raise ValueError(f"fused_step kernel needs CUDA tensors, got device {dev}")

    plan = step_plan(layers, n_f, n_u)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    if out is None:
        out = {
            "params": empty(E, n_params), "mu": empty(E, n_params), "nu": empty(E, n_params),
            "colloc": empty(E, n_f, 2),
            "z": empty(E, n_f, 1) if z is not None else None,
            "dual": empty(E, n_f, 1) if z is not None else None,
        }
    out = dict(out, metrics=metrics_out if metrics_out is not None else empty(E, 7),
               grad=empty(E, n_params) if want_grad else None)
    if scratch is None:
        scratch = _scratch(plan, spec, E, dev)
    tensors = {
        "params": params, "mu": mu, "nu": nu, "x_data": x_data, "u_data": u_data,
        "colloc": colloc, "z": z, "dual": dual, "new_colloc": new_colloc,
        "params_out": out["params"], "mu_out": out["mu"], "nu_out": out["nu"],
        "colloc_out": out["colloc"], "z_out": out["z"], "dual_out": out["dual"],
        "metrics": out["metrics"], "grad_out": out["grad"], "members": members, **scratch,
        "cursor": None if chunk is None else chunk[0], "sched": None if chunk is None else chunk[1],
        "loss_out": None, "skip": None,
    }
    bc1, bc2 = bias_corrections(count)
    floats = {
        "lb0": spec.lb[0], "lb1": spec.lb[1], "ub0": spec.ub[0], "ub1": spec.ub[1],
        "lam1": lam1, "lam2": lam2, "rho": 0.0 if rho is None else rho, "lr": lr,
        "one_minus_b1": 1.0 - B1, "b1": B1, "one_minus_b2": 1.0 - B2, "b2": B2, "eps": EPS,
        "bc1": bc1, "bc2": bc2, "threshold": 0.0 if rho is None else 1.0 / (rho * n_f),
    }
    ints = {
        "n_u": n_u, "n_f": n_f, "kind": KINDS[kind], "explicit_inner": int(explicit_inner),
        "tile": plan.tile, "tail_tile": plan.tail_tile, "seed": int(seed), "epoch": int(epoch),
        "device": dev.index if dev.index is not None else torch.cuda.current_device(),
        "nf_pad": plan.nf_pad, "nu_pad": plan.nu_pad, "split_rows": plan.split_rows,
        "splits": plan.splits, "scratch_floats": plan.scratch_floats, "n_members": E,
        "metrics_stride": 7 * E, "new_colloc_stride": 2 * n_f * E,
        "launch_only": int(launch_only), "value_and_grad": 0,
    }
    _call(layers, tensors, floats, ints, dev,
          f"widths={layers} members={E} plan={dataclasses.asdict(plan)}")
    return out


def _call(layers: Sequence[int], tensors: dict, floats: dict, ints: dict, dev, what: str,
          entry: str = "pinns_fused_step"):
    """One host call of ``entry`` (``pinns_fused_step`` or
    ``pinns_fused_post_update``) with the argument slots by name (a missing
    pointer is null); raises with ``what`` on a failed launch."""
    lib = _lib()
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    c_dims = (ctypes.c_int * len(layers))(*layers)
    c_ptrs = (ctypes.c_longlong * len(_PTRS))(
        *(tensors[k].data_ptr() if tensors.get(k) is not None else 0 for k in _PTRS))
    c_floats = (ctypes.c_float * len(_FLOATS))(*(f32(floats[k]) for k in _FLOATS))
    c_ints = (ctypes.c_longlong * len(_INTS))(*(int(ints[k]) for k in _INTS))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(c_dims, len(layers) - 1, c_ptrs, c_floats, c_ints, stream)
    if err != 0:
        msg = lib.pinns_fused_step_error_string(err).decode()
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {err} ({msg}); {what}")


def fused_adam_step(
    spec: MLPSpec,
    params: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    count: int,
    x_data: torch.Tensor,
    u_data: torch.Tensor,
    colloc: torch.Tensor,
    z: Optional[torch.Tensor],
    dual: Optional[torch.Tensor],
    *,
    kind: str,
    lam1: float,
    lam2: float,
    rho: float,
    lr: float,
    explicit_inner: bool,
    seed: int,
    epoch: int,
    new_colloc: Optional[torch.Tensor] = None,
    metrics_out: Optional[torch.Tensor] = None,
    want_grad: bool = False,
) -> Dict[str, torch.Tensor]:
    """One Adam epoch in one call of the CUDA step: four launches (narrow
    design) or the wide design's layer products, all from one host call.

    ``params``/``mu``/``nu`` are flat float32 buffers in ``pack_params`` order;
    ``count`` is Adam's step count before this step. The new batch is the
    Philox draw of (``seed``, ``epoch``), or ``new_colloc`` when given.
    Returns new tensors {params, mu, nu, colloc, z, dual, metrics, grad}; the
    inputs are not modified. ``metrics`` (7 floats, ``METRIC_KEYS`` order) is
    ``metrics_out`` when given; ``grad`` is the reduced gradient the Adam
    stage used when ``want_grad``, else None. (The member-batched call with
    one member, :func:`_epoch`.)
    """
    global LAUNCHES
    one = lambda t: None if t is None else t.unsqueeze(0)  # noqa: E731
    if colloc.dim() != 2:
        raise ValueError(f"fused_step kernel: colloc must be (N_f, 2), got {tuple(colloc.shape)}")
    r = _epoch(spec, 1, one(params), one(mu), one(nu), count, x_data, u_data, one(colloc),
               one(z), one(dual), kind=kind, lam1=lam1, lam2=lam2, rho=rho, lr=lr,
               explicit_inner=explicit_inner, seed=seed, epoch=epoch,
               new_colloc=one(new_colloc), metrics_out=one(metrics_out), want_grad=want_grad)
    with _launches_lock:
        LAUNCHES += 1
    out = {k: None if v is None else v[0] for k, v in r.items()}
    if metrics_out is not None:
        out["metrics"] = metrics_out
    return out


def fused_adam_ensemble_step(
    spec: MLPSpec,
    params: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    count: int,
    x_data: torch.Tensor,
    u_data: torch.Tensor,
    colloc: torch.Tensor,
    z: Optional[torch.Tensor],
    dual: Optional[torch.Tensor],
    members: torch.Tensor,
    *,
    kind: str,
    lam1: float,
    lam2: float,
    lr: float,
    explicit_inner: bool,
    epoch: int,
    new_colloc: Optional[torch.Tensor] = None,
    metrics_out: Optional[torch.Tensor] = None,
    want_grad: bool = False,
) -> Dict[str, torch.Tensor]:
    """K8: one Adam epoch of E ensemble members in one host call of the CUDA
    step (the narrow design's four launches, each over all members).

    ``params``/``mu``/``nu`` are (E, n_params) in ``pack_params`` order,
    ``colloc`` (E, N_f, 2), ``z``/``dual`` (E, N_f, 1) or None, and
    ``members`` the (E, 4) table of :func:`member_table` (each member's seed,
    rho and threshold); the data, the coefficients, ``lr``, Adam's shared
    ``count`` and the ``epoch`` are the members' common ones (they run in
    lockstep). ``new_colloc`` (E, N_f, 2) replaces the Philox draws and
    ``metrics_out`` (E, 7) receives the metrics. Returns new (E, ...) tensors
    as :func:`fused_adam_step` does; member m of them equals a solo call of
    member m bit for bit.
    """
    global ENSEMBLE_LAUNCHES
    r = _epoch(spec, params.shape[0], params, mu, nu, count, x_data, u_data, colloc, z, dual,
               kind=kind, lam1=lam1, lam2=lam2, rho=None, lr=lr, explicit_inner=explicit_inner,
               seed=0, epoch=epoch, members=members, new_colloc=new_colloc,
               metrics_out=metrics_out, want_grad=want_grad)
    with _launches_lock:
        ENSEMBLE_LAUNCHES += 1
    return r


def unpack_params(flat: torch.Tensor, layers: Sequence[int]) -> Params:
    """JAX-layout layers as views of a flat buffer in ``pack_params`` order;
    a leading member axis of ``flat`` (E, n_params) leads every leaf."""
    lead = tuple(flat.shape[:-1])
    out, off = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        w = flat[..., off:off + din * dout].view(*lead, din, dout)
        off += din * dout
        out.append({"W": w, "b": flat[..., off:off + dout].view(*lead, 1, dout)})
        off += dout
    return out


def _step_config(problem, learning_rate: float) -> dict:
    """The step's configuration arguments (residual kind, the effective
    coefficients, lr, explicit_inner); raises ``NotImplementedError`` for a
    configuration outside the kernel's scope."""
    exp, spec = problem.exp, problem.spec
    why = fused_step_supported(exp, spec)
    if why:
        raise NotImplementedError(
            f"experiment {exp.name!r} is outside the fused CUDA step's scope ({'; '.join(why)}); "
            "train.trainer.make_step gives it the generic Adam step over the kernel ops"
        )
    return dict(loss_config(exp), lr=learning_rate)


def loss_config(exp) -> dict:
    """The loss's configuration arguments of the kernel: the residual kind,
    the effective coefficients (lambda2 through its transform, rounded as the
    JAX step rounds it) and explicit_inner."""
    lam2_raw = exp.pde.lambda2
    lam2 = float(np.exp(np.float32(lam2_raw))) if exp.pde.lambda2_transform == "exp" else lam2_raw
    return dict(kind=exp.loss.residual_kind, lam1=exp.pde.lambda1, lam2=lam2,
                explicit_inner=exp.loss.explicit_inner)


def flat_net(net: Params, n_params: int) -> torch.Tensor:
    """The flat buffer (..., n_params), in ``pack_params`` order, whose views
    the net's leaves are (as :func:`unpack_params` and the ensemble's stack
    lay them out: the step's outputs feed the next epoch as they are); a net
    laid out otherwise is packed into a new buffer."""
    leaves = net_leaves(net)
    lead = tuple(leaves[0].shape[:-2])
    base = leaves[0]._base
    if (base is not None and base.is_contiguous() and base.numel() == math.prod(lead) * n_params
            and leaves[0].data_ptr() == base.data_ptr()
            and all(t._base is base for t in leaves)):
        return base.view(*lead, n_params)
    return torch.cat([t.reshape(*lead, -1) for t in leaves], dim=-1)


def _after_epoch(state, r: dict, layers: Sequence[int], epochs: int = 1):
    """The state after ``epochs`` epochs whose outputs are ``r`` (a member
    axis leads every tensor of an ensemble's), and the metrics as views of
    their rows."""
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.train.trainer import METRIC_KEYS

    opt = state.opt_state
    new_state = state._replace(
        params=dict(state.params, net=unpack_params(r["params"], layers)),
        opt_state=AdamState(count=opt.count + epochs,
                            mu=dict(opt.mu, net=unpack_params(r["mu"], layers)),
                            nu=dict(opt.nu, net=unpack_params(r["nu"], layers))),
        admm=None if state.admm is None else ADMMState(z=r["z"], dual=r["dual"]),
        colloc=r["colloc"], epoch=state.epoch + epochs,
    )
    return new_state, {k: r["metrics"][..., i] for i, k in enumerate(METRIC_KEYS)}


def make_fused_ensemble_step(problem, learning_rate: float):
    """K8's step over a stacked ensemble state (``parallel.ensemble``):
    ``step(stacked, out=None, new_colloc=None) -> (stacked, metrics)``, one
    host call an epoch for all members. ``out``, an (E, 7) float32 row,
    receives the metrics; ``new_colloc`` (E, N_f, 2) replaces the Philox
    draws. Each member trains with its own seed (``stacked.key``) and rho
    (``stacked.rho``, else ``loss.rho``).

    Raises ``NotImplementedError`` outside K3's scope or for a net wider
    than the narrow design's: those ensembles run the member loop.
    """
    exp, spec = problem.exp, problem.spec
    cfg = _step_config(problem, learning_rate)
    _narrow_members(spec)
    u_data = problem.targets["u"].contiguous()
    cached = {}  # the member table of the last (seeds, rhos): constant over a run

    def step(stacked, out: Optional[torch.Tensor] = None,
             new_colloc: Optional[torch.Tensor] = None):
        n = len(stacked.key)
        rhos = stacked.rho if stacked.rho is not None else (exp.loss.rho,) * n
        if cached.get("key") != (stacked.key, rhos):
            cached["key"] = (stacked.key, rhos)
            cached["table"] = member_table(stacked.key, rhos, stacked.colloc.shape[1],
                                           stacked.colloc.device)
        opt, admm = stacked.opt_state, stacked.admm
        r = fused_adam_ensemble_step(
            spec, flat_net(stacked.params["net"], spec.n_params),
            flat_net(opt.mu["net"], spec.n_params), flat_net(opt.nu["net"], spec.n_params),
            opt.count, problem.x_data, u_data, stacked.colloc,
            admm.z if admm is not None else None, admm.dual if admm is not None else None,
            cached["table"], epoch=stacked.epoch + 1, new_colloc=new_colloc, metrics_out=out,
            **cfg,
        )
        return _after_epoch(stacked, r, spec.layers)

    return step


def _narrow_members(spec: MLPSpec) -> None:
    if design(spec.layers) != "narrow":
        raise NotImplementedError(
            f"widths {spec.layers} take K3's wide design, which runs one member a call; "
            "their ensembles run the member loop (parallel.ensemble.make_ensemble_chunk)")


def make_fused_adam_step(problem, learning_rate: float):
    """``step(state, out=None, new_colloc=None) -> (state, metrics)``: the plain step's contract
    (``train.trainer.make_adam_step``) with one CUDA step call per epoch.
    ``step.graphed(max_len=...)`` makes the step's K9 runner
    (:class:`FusedChunk`), which ``train.trainer.make_chunked`` takes.

    Raises ``NotImplementedError`` for a configuration outside the kernel's
    scope: on the card nothing falls back to the plain step.
    """
    exp, spec = problem.exp, problem.spec
    cfg = _step_config(problem, learning_rate)
    u_data = problem.targets["u"].contiguous()

    def step(state, out: Optional[torch.Tensor] = None,
             new_colloc: Optional[torch.Tensor] = None):
        opt, admm = state.opt_state, state.admm
        r = fused_adam_step(
            spec, flat_net(state.params["net"], spec.n_params),
            flat_net(opt.mu["net"], spec.n_params), flat_net(opt.nu["net"], spec.n_params),
            opt.count, problem.x_data, u_data, state.colloc,
            admm.z if admm is not None else None, admm.dual if admm is not None else None,
            rho=exp.loss.rho if state.rho is None else state.rho, seed=state.key,
            epoch=state.epoch + 1, new_colloc=new_colloc, metrics_out=out, **cfg,
        )
        return _after_epoch(state, r, spec.layers)

    step.graphed = functools.partial(FusedChunk, problem, learning_rate)
    return step


# -- K9: a chunk of epochs as captured CUDA graphs -------------------------------

def chunk_schedule(count: int, epoch: int, length: int) -> np.ndarray:
    """K9: the schedule of ``length`` epochs from Adam's ``count`` and the
    state's ``epoch``, a row an epoch as the per-epoch step takes them: the
    Philox epoch ``epoch + 1 + i`` as its low and high words, then Adam's bias
    corrections at ``count + i`` (:func:`opt.adam.bias_corrections`: numpy's
    float32 power, whose bits a device ``powf`` need not give) as float32
    bits. (length, 4) int32, the kernel's ``sched``."""
    tab = np.empty((length, 4), np.uint32)
    e = np.arange(length, dtype=np.uint64) + np.uint64(epoch + 1)
    tab[:, 0] = (e & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tab[:, 1] = (e >> np.uint64(32)).astype(np.uint32)
    tab[:, 2:] = np.asarray([bias_corrections(count + i) for i in range(length)],
                            np.float32).view(np.uint32)
    return tab.view(np.int32)


# the epochs of each captured graph, as (from, to) buffers: A is 0, B is 1
GRAPH_EPOCH_BUFFERS = {"pair": ((0, 1), (1, 0)), "single": ((0, 1),)}


def replay_plan(length: int) -> Tuple[str, ...]:
    """K9: the graphs a chunk of ``length`` epochs replays, in order: the
    two-epoch graph (A -> B -> A) length // 2 times, then for an odd length
    the one-epoch graph (A -> B); the state ends in B then, else in A."""
    return ("pair",) * (length // 2) + ("single",) * (length % 2)


def hand_back(state, final: dict, metrics: torch.Tensor, length: int, layers: Sequence[int],
              stacked: bool):
    """The state after ``length`` epochs from ``state`` whose last one wrote
    ``final`` (a runner's buffers, every tensor (E, ...)), as tensors of the
    caller's own (one device copy each: the next replay may write the
    buffers), and the metrics, a copy of the chunk's rows of ``metrics``
    (rows, E, 7): {metric: (length,)} solo, {metric: (length, E)} stacked."""
    own = {k: None if v is None else v.clone() for k, v in final.items()}
    own["metrics"] = metrics[:length].clone()
    if not stacked:
        own = {k: None if v is None else (v[:, 0] if k == "metrics" else v[0])
               for k, v in own.items()}
    return _after_epoch(state, own, layers, length)


class FusedChunk:
    """K9: chunks of the fused step's Adam epochs (solo K3, or K8 over
    ``n_members`` members of a stacked state) as captured CUDA graphs.

    Allocated once: two state buffers A and B (params, mu, nu as (E,
    n_params), colloc, z, dual), the epoch's scratch, a device cursor, a
    schedule of ``max_len`` rows (:func:`chunk_schedule`) and ``max_len``
    metrics rows. Captured once, after one uncaptured warm-up epoch on the
    runner's own buffers (the kernels' set-up, outside capture): a graph of
    two epochs (A -> B -> A) and one of one epoch (A -> B), each launch
    reading its epoch's row through the cursor. A chunk of L epochs
    (:meth:`run`) copies the state into A, writes L schedule rows, zeroes
    the cursor and replays :func:`replay_plan` (L), with no host sync; the
    state comes back in tensors of the caller's own (:func:`hand_back`).
    Every epoch runs the per-epoch call's kernels in its order and
    arithmetic, so a chunk equals the per-epoch loop bit for bit.

    The graphs hold the solo seed and rho as the captured launches took
    them; a state of another seed or rho captures anew. K8's member table
    is a buffer the graphs read: another ensemble's seeds and rhos are
    copied into it. Given points (``new_colloc``) take a second pair of
    graphs that read them through the cursor. A chunk longer than
    ``max_len`` reallocates the rows and captures anew. A capture or replay
    that fails raises; nothing falls back to the per-epoch loop.

    ``n_members`` None runs the trainer's solo state, an int a stacked state
    of that many members (``parallel.ensemble``); ``max_len`` (default
    ``train.chunk``) is the longest chunk it runs without capturing anew.
    Raises ``NotImplementedError`` outside K3's scope (K8: outside its narrow
    design) and ``ValueError`` off the card.
    """

    def __init__(self, problem, learning_rate: float, n_members: Optional[int] = None,
                 max_len: Optional[int] = None):
        exp, spec = problem.exp, problem.spec
        self.cfg = _step_config(problem, learning_rate)
        self.stacked = n_members is not None
        if self.stacked:
            _narrow_members(spec)
        if problem.device.type != "cuda":
            raise ValueError(f"K9 runs on a CUDA device, got {problem.device}")
        self.exp, self.spec, self.device = exp, spec, problem.device
        self.n_members = int(n_members) if self.stacked else 1
        self.x_data = problem.x_data
        self.u_data = problem.targets["u"].contiguous()
        self.n_f, n_u = exp.sampling.n_f, self.x_data.shape[0]
        E, P, F = self.n_members, spec.n_params, self.n_f
        admm = exp.loss.residual_kind == "admm"
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=self.device)
        self.bufs = tuple({"params": zeros(E, P), "mu": zeros(E, P), "nu": zeros(E, P),
                           "colloc": zeros(E, F, 2), "z": zeros(E, F, 1) if admm else None,
                           "dual": zeros(E, F, 1) if admm else None} for _ in range(2))
        self.scratch = _scratch(step_plan(spec.layers, F, n_u), spec, E, self.device)
        self.cursor = zeros(1, dtype=torch.int32)
        self.table = zeros(E, 4, dtype=torch.int32) if self.stacked else None
        self.key = None
        self.graphs: Dict[bool, Dict[str, torch.cuda.CUDAGraph]] = {}
        self.capture_seconds: List[float] = []
        self._rows(max(1, int(exp.train.chunk if max_len is None else max_len)))

    def _rows(self, n: int) -> None:
        """Schedule and metrics rows for chunks of up to ``n`` epochs (the
        graphs hold their addresses: capture anew)."""
        self.max_len = n
        self.sched = torch.zeros((n, 4), dtype=torch.int32, device=self.device)
        self.metrics = torch.zeros((n, self.n_members, 7), dtype=torch.float32,
                                   device=self.device)
        self.feed = None
        self.graphs.clear()

    def _set_key(self, state) -> None:
        """The seeds and rhos the graphs run: the solo ones captured into
        them, K8's copied into its member table."""
        if self.stacked:
            if len(state.key) != self.n_members:
                raise ValueError(f"K9: a {len(state.key)}-member state for a runner of "
                                 f"{self.n_members}")
            rhos = state.rho if state.rho is not None else (self.exp.loss.rho,) * self.n_members
            key = (tuple(int(k) for k in state.key), tuple(float(r) for r in rhos))
            if key != self.key:
                self.table.copy_(member_table(*key, self.n_f, self.device))
        else:
            key = (int(state.key), float(self.exp.loss.rho if state.rho is None else state.rho))
            if key != self.key:
                self.graphs.clear()
        self.key = key

    def _launch(self, src: dict, dst: dict, fed: bool, launch_only: bool) -> None:
        seed, rho = (0, None) if self.stacked else self.key
        _epoch(self.spec, self.n_members, src["params"], src["mu"], src["nu"], 0, self.x_data,
               self.u_data, src["colloc"], src["z"], src["dual"], rho=rho, seed=seed, epoch=0,
               members=self.table, new_colloc=self.feed if fed else None,
               metrics_out=self.metrics, out=dst, scratch=self.scratch,
               chunk=(self.cursor, self.sched), launch_only=launch_only, **self.cfg)

    def _capture(self, fed: bool) -> Dict[str, torch.cuda.CUDAGraph]:
        t0 = time.perf_counter()
        a, b = self.bufs
        self.cursor.zero_()
        self._launch(a, b, fed, launch_only=False)  # the warm-up: the set-up, outside capture
        torch.cuda.synchronize(self.device)
        graphs = {name: torch.cuda.CUDAGraph() for name in GRAPH_EPOCH_BUFFERS}
        for name, epochs in GRAPH_EPOCH_BUFFERS.items():
            with torch.cuda.graph(graphs[name]):
                for i, j in epochs:
                    self._launch(self.bufs[i], self.bufs[j], fed, launch_only=True)
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t0)
        return graphs

    def _load(self, state, dst: dict) -> None:
        """The state's tensors into the buffers ``dst`` (one that already is
        its buffer is left as it is)."""
        P, opt, admm = self.spec.n_params, state.opt_state, state.admm
        if (admm is None) != (dst["z"] is None):
            raise ValueError("K9: the state's ADMM state does not match the residual kind")
        src = {"params": flat_net(state.params["net"], P), "mu": flat_net(opt.mu["net"], P),
               "nu": flat_net(opt.nu["net"], P), "colloc": state.colloc,
               "z": None if admm is None else admm.z, "dual": None if admm is None else admm.dual}
        for k, t in src.items():
            if t is not None and t.data_ptr() != dst[k].data_ptr():
                dst[k].copy_(t.reshape(dst[k].shape))

    def run(self, state, length: int, new_colloc: Optional[torch.Tensor] = None):
        """``length`` epochs from ``state``: (state, metrics) as the
        per-epoch loop (``train.trainer.run_chunk``) gives them, bit for bit.
        ``new_colloc`` ((length, N_f, 2), or (length, E, N_f, 2) stacked)
        replaces the Philox draws."""
        global GRAPH_REPLAYS, GRAPH_EPOCHS
        if length < 1:
            raise ValueError(f"K9: a chunk of {length} epochs")
        if length > self.max_len:
            self._rows(length)
        fed = new_colloc is not None
        if fed and self.feed is None:
            self.feed = torch.zeros((self.max_len, self.n_members, self.n_f, 2),
                                    dtype=torch.float32, device=self.device)
        self._set_key(state)
        if fed not in self.graphs:
            self.graphs[fed] = self._capture(fed)
        self._load(state, self.bufs[0])
        sched = chunk_schedule(state.opt_state.count, state.epoch, length)
        self.sched[:length].copy_(torch.from_numpy(sched), non_blocking=True)
        if fed:
            self.feed[:length].copy_(new_colloc.reshape(self.feed[:length].shape))
        self.cursor.zero_()
        plan = replay_plan(length)
        for name in plan:
            self.graphs[fed][name].replay()
        with _launches_lock:
            GRAPH_REPLAYS += len(plan)
            GRAPH_EPOCHS += length
        return hand_back(state, self.bufs[length % 2], self.metrics, length, self.spec.layers,
                         self.stacked)


# -- K10's value-and-grad: the narrow grad kernel and the partials' sum ---------

def fused_value_and_grad(
    spec: MLPSpec,
    params: torch.Tensor,
    grad: torch.Tensor,
    loss: torch.Tensor,
    x_data: torch.Tensor,
    u_data: torch.Tensor,
    colloc: torch.Tensor,
    z: Optional[torch.Tensor],
    dual: Optional[torch.Tensor],
    *,
    kind: str,
    lam1: float,
    lam2: float,
    rho: float,
    explicit_inner: bool,
    partials: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    launch_only: bool = False,
) -> None:
    """K3's value-and-grad mode, K10's evaluation: the loss of the step's
    configuration at the flat ``params`` (n_params, ``pack_params`` order)
    and the fixed batch, z, dual and rho, into ``loss`` (1,), and its
    gradient into ``grad`` (n_params,): the narrow grad kernel and the
    partials' sum of an Adam epoch, two launches, no Adam, tail or metrics.
    With ``skip`` (an int32 (1,) tensor, K10's done flag) both launches
    return at once while it is not 0. ``partials`` is the scratch
    (blocks, n_params + 1) of :func:`step_plan`, allocated when None.
    ``launch_only`` issues the launches alone (a stream capture).

    On CPU tensors the plain version, :func:`value_and_grad_reference`; on
    CUDA tensors the kernel, or it raises (the narrow design only).
    """
    global VALUE_AND_GRAD_LAUNCHES
    _value_and_grad_call(spec, params, grad, loss, x_data, u_data, colloc, z, dual, kind=kind,
                         lam1=lam1, lam2=lam2, rho=rho, explicit_inner=explicit_inner,
                         partials=partials, skip=skip, launch_only=launch_only)
    if params.device.type == "cuda":
        with _launches_lock:
            VALUE_AND_GRAD_LAUNCHES += 1


def _value_and_grad_call(spec: MLPSpec, params, grad, loss, x_data, u_data, colloc, z, dual, *,
                         kind: str, lam1: float, lam2: float, rho: float, explicit_inner: bool,
                         partials=None, skip=None, launch_only: bool = False) -> None:
    """:func:`fused_value_and_grad` without the count (K10's warm-up and
    graph capture, whose replays its runner counts)."""
    dev = params.device
    layers = spec.layers
    n_f, n_u, P = colloc.shape[0], x_data.shape[0], spec.n_params
    if kind not in KINDS:
        raise ValueError(f"value_and_grad: residual kind {kind!r} not in {sorted(KINDS)}")
    if (kind == "admm") != (z is not None and dual is not None):
        raise ValueError("value_and_grad: z/dual are given exactly when kind == 'admm'")
    if spec.in_dim != 2 or spec.out_dim != 1 or design(layers) != "narrow" \
            or not 2 <= len(layers) - 1 <= MAX_LAYERS or launch_config(layers)[0] == 0:
        raise ValueError(f"value_and_grad takes K3's narrow design, got widths {layers}")
    shapes = {"params": (params, (P,)), "grad": (grad, (P,)), "loss": (loss, (1,)),
              "x_data": (x_data, (n_u, 2)), "u_data": (u_data, (n_u, 1)),
              "colloc": (colloc, (n_f, 2))}
    if z is not None:
        shapes.update(z=(z, (n_f, 1)), dual=(dual, (n_f, 1)))
    plan = step_plan(layers, n_f, n_u)
    if partials is not None:
        shapes["partials"] = (partials, (plan.blocks, P + 1))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"value_and_grad: {name} must be contiguous float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if skip is not None and (tuple(skip.shape) != (1,) or skip.dtype != torch.int32
                             or skip.device != dev):
        raise ValueError(f"value_and_grad: skip must be one int32 on {dev}")
    if n_f < 1 or n_u < 1:
        raise ValueError("value_and_grad needs at least one collocation and one data point")
    if dev.type == "cpu":
        if skip is not None and int(skip[0]) != 0:
            return
        f, g = value_and_grad_reference(spec, params, x_data, u_data, colloc, z, dual,
                                        kind=kind, lam1=lam1, lam2=lam2, rho=rho,
                                        explicit_inner=explicit_inner)
        loss.copy_(f.reshape(1))
        grad.copy_(g)
        return
    if dev.type != "cuda":
        raise ValueError(f"value_and_grad needs CPU or CUDA tensors, got device {dev}")
    if partials is None:
        partials = torch.empty((plan.blocks, P + 1), dtype=torch.float32, device=dev)
    tensors = {"params": params, "x_data": x_data, "u_data": u_data, "colloc": colloc, "z": z,
               "dual": dual, "grad_out": grad, "loss_out": loss, "partials": partials,
               "skip": skip}
    floats = dict.fromkeys(_FLOATS, 0.0)
    floats.update(lb0=spec.lb[0], lb1=spec.lb[1], ub0=spec.ub[0], ub1=spec.ub[1], lam1=lam1,
                  lam2=lam2, rho=rho if kind == "admm" else 0.0)
    ints = dict.fromkeys(_INTS, 0)
    ints.update(n_u=n_u, n_f=n_f, kind=KINDS[kind], explicit_inner=int(explicit_inner),
                tile=plan.tile, tail_tile=plan.tail_tile,
                device=dev.index if dev.index is not None else torch.cuda.current_device(),
                n_members=1, launch_only=int(launch_only), value_and_grad=1)
    _call(layers, tensors, floats, ints, dev, f"value_and_grad widths={layers}")


def value_and_grad_reference(
    spec: MLPSpec, params: torch.Tensor, x_data, u_data, colloc, z, dual, *,
    kind: str, lam1: float, lam2: float, rho: float, explicit_inner: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The value-and-grad mode in plain PyTorch: (loss (0-d), gradient
    (n_params,) in ``pack_params`` order) at the flat ``params``, by
    :func:`loss_and_grad_reference`, the kernel's algorithm."""
    f, _, _, grads = loss_and_grad_reference(
        spec, unpack_params(params, spec.layers), x_data, u_data, colloc, z, dual, kind=kind,
        lam1=lam1, lam2=lam2, rho=rho, explicit_inner=explicit_inner)
    return f, torch.cat([g.reshape(-1) for g in grads])


# -- K3's post-update mode: the tail and finalize after one of K10's solves ------

def post_update_tail(layers: Sequence[int], n_f: int, n_u: int) -> Tuple[int, int]:
    """(collocation tiles, data tiles) of the post-update mode's tail
    launch, whose sums its scratch holds in that order."""
    _, tail = launch_config(layers)
    return -(-n_f // tail), -(-n_u // tail)


def fused_post_update(
    spec: MLPSpec,
    params: torch.Tensor,
    x_data: torch.Tensor,
    u_data: torch.Tensor,
    colloc: torch.Tensor,
    z: Optional[torch.Tensor],
    dual: Optional[torch.Tensor],
    metrics: torch.Tensor,
    cursor: torch.Tensor,
    sched: torch.Tensor,
    members: torch.Tensor,
    f_in: torch.Tensor,
    iters_in: torch.Tensor,
    *,
    kind: str,
    lam1: float,
    lam2: float,
    feed: Optional[torch.Tensor] = None,
    fixed: bool = False,
    tail_partials: Optional[torch.Tensor] = None,
    launch_only: bool = False,
) -> None:
    """K3's post-update mode, after one of K10's outer solves: the narrow
    tail and finalize kernels of one member (two launches, no grad or Adam).

    ``params`` (n_params,) is the solve's net (K10's ``vec[X]`` from the
    net's offset on). The new batch goes into ``colloc`` (N_f, 2) IN PLACE:
    the Philox draw of ``members``' seed (a one-row :func:`member_table`,
    which also gives rho and the threshold) at the epoch words of row
    ``cursor`` of ``sched`` (:func:`chunk_schedule`), row ``cursor`` of
    ``feed`` (rows, N_f, 2) when given, or the batch itself when ``fixed``.
    Under ``kind`` 'admm' the residual there with ``params`` updates ``z``
    and ``dual`` (N_f, 1) in place (the threshold divides by the batch's
    row count). Row ``cursor`` of ``metrics`` (rows, 7, ``METRIC_KEYS``
    order) gets the solve's f (``f_in``, K10's sf[F_F:F_F + 1]) as the loss,
    the data term at ``params`` over ``x_data``/``u_data``, res_term = f -
    data_term, lambda1/2, the misfit mean|f - z| (0 for another kind) and
    the iterations (``iters_in``, K10's si[I_K:I_K + 1]); then the cursor
    advances. ``tail_partials`` is the scratch (:func:`post_update_tail`'s
    tiles), allocated when None; ``launch_only`` issues the launches alone
    (a stream capture).

    On CPU tensors the plain version, :func:`post_update_reference`; on CUDA
    tensors the kernels, or it raises.
    """
    global POST_UPDATE_LAUNCHES
    _post_update_call(spec, params, x_data, u_data, colloc, z, dual, metrics, cursor, sched,
                      members, f_in, iters_in, kind=kind, lam1=lam1, lam2=lam2, feed=feed,
                      fixed=fixed, tail_partials=tail_partials, launch_only=launch_only)
    if params.device.type == "cuda":
        with _launches_lock:
            POST_UPDATE_LAUNCHES += 1


def _post_update_call(spec: MLPSpec, params, x_data, u_data, colloc, z, dual, metrics, cursor,
                      sched, members, f_in, iters_in, *, kind: str, lam1: float, lam2: float,
                      feed=None, fixed: bool = False, tail_partials=None,
                      launch_only: bool = False) -> None:
    """:func:`fused_post_update` without the count (K10's chunk runner
    counts its replays)."""
    dev = params.device
    layers = spec.layers
    n_f, n_u, P = colloc.shape[0], x_data.shape[0], spec.n_params
    if kind not in KINDS:
        raise ValueError(f"post_update: residual kind {kind!r} not in {sorted(KINDS)}")
    if (kind == "admm") != (z is not None and dual is not None):
        raise ValueError("post_update: z/dual are given exactly when kind == 'admm'")
    if fixed and feed is not None:
        raise ValueError("post_update: a fixed batch takes no fed points")
    if spec.in_dim != 2 or spec.out_dim != 1 or design(layers) != "narrow" \
            or not 2 <= len(layers) - 1 <= MAX_LAYERS:
        raise ValueError(f"post_update takes K3's narrow design, got widths {layers}")
    rows = metrics.shape[0] if metrics.dim() == 2 else -1
    floats = {"params": (params, (P,)), "x_data": (x_data, (n_u, 2)), "u_data": (u_data, (n_u, 1)),
              "colloc": (colloc, (n_f, 2)), "metrics": (metrics, (rows, 7)), "f_in": (f_in, (1,))}
    if z is not None:
        floats.update(z=(z, (n_f, 1)), dual=(dual, (n_f, 1)))
    if feed is not None:
        floats["feed"] = (feed, (rows, n_f, 2))
    tiles = sum(post_update_tail(layers, n_f, n_u))
    if tail_partials is not None:
        floats["tail_partials"] = (tail_partials, (tiles,))
    for name, (t, shape) in floats.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"post_update: {name} must be contiguous float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    ints = {"cursor": (cursor, (1,)), "iters_in": (iters_in, (1,)), "sched": (sched, (rows, 4)),
            "members": (members, (1, 4))}
    for name, (t, shape) in ints.items():
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"post_update: {name} must be contiguous int32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n_f < 1 or n_u < 1 or rows < 1:
        raise ValueError("post_update needs a collocation point, a data point and a row")
    if dev.type == "cpu":
        post_update_reference(spec, params, x_data, u_data, colloc, z, dual, metrics, cursor,
                              sched, members, f_in, iters_in, kind=kind, lam1=lam1, lam2=lam2,
                              feed=feed, fixed=fixed)
        return
    if dev.type != "cuda":
        raise ValueError(f"post_update needs CPU or CUDA tensors, got device {dev}")
    if tail_partials is None:
        tail_partials = torch.empty(tiles, dtype=torch.float32, device=dev)
    plan = step_plan(layers, n_f, n_u)
    tensors = {"params_out": params, "x_data": x_data, "u_data": u_data, "colloc": colloc,
               "colloc_out": colloc, "z": z, "z_out": z, "dual": dual, "dual_out": dual,
               "new_colloc": colloc if fixed else feed, "metrics": metrics,
               "tail_partials": tail_partials, "members": members, "cursor": cursor,
               "sched": sched, "f_in": f_in, "iters_in": iters_in}
    floats = dict.fromkeys(_FLOATS, 0.0)
    floats.update(lb0=spec.lb[0], lb1=spec.lb[1], ub0=spec.ub[0], ub1=spec.ub[1], lam1=lam1,
                  lam2=lam2)
    ints = dict.fromkeys(_INTS, 0)
    ints.update(n_u=n_u, n_f=n_f, kind=KINDS[kind], tile=plan.tile, tail_tile=plan.tail_tile,
                device=dev.index if dev.index is not None else torch.cuda.current_device(),
                n_members=1, metrics_stride=7, new_colloc_stride=0 if fixed else 2 * n_f,
                launch_only=int(launch_only))
    _call(layers, tensors, floats, ints, dev, f"post_update widths={layers}",
          entry="pinns_fused_post_update")


def member_scalars(members: torch.Tensor) -> Tuple[int, float, float]:
    """(seed, rho, threshold) of a one-row :func:`member_table`, as the
    kernel reads them (rho and the threshold float32)."""
    w = members[0].cpu().numpy().view(np.uint32)
    f = w[2:].view(np.float32)
    return int(w[0]) | int(w[1]) << 32, float(f[0]), float(f[1])


def post_update_reference(spec: MLPSpec, params, x_data, u_data, colloc, z, dual, metrics,
                          cursor, sched, members, f_in, iters_in, *, kind: str, lam1: float,
                          lam2: float, feed=None, fixed: bool = False) -> None:
    """The post-update mode in plain PyTorch: the trainer's L-BFGS tail
    (``train.trainer._post_update``: the batch, then z/dual at it with the
    new params), its data-term metric (``make_data_term``) and res_term =
    f - data_term, on the tensors :func:`fused_post_update` takes, in place.
    The batch is ``data.sampling.philox_uniform`` (seed and epoch words as
    the kernel reads them), the fed row or the batch itself; the residual
    the plain Taylor-2 recurrence; z and dual ``losses.admm``'s update with
    the table's float32 rho and threshold."""
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.losses.misfit import data_misfit
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.prox import soft_threshold
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    row = int(cursor[0])
    words = sched[row].cpu().numpy().view(np.uint32)
    seed, rho, threshold = member_scalars(members)
    n_f, n_u = colloc.shape[0], x_data.shape[0]
    net = unpack_params(params, spec.layers)
    if fixed:
        new = colloc
    elif feed is not None:
        new = feed[row]
    else:
        new = philox_uniform(seed, int(words[0]) | int(words[1]) << 32, n_f, spec.lb, spec.ub,
                             torch.float32, colloc.device)
    dt = metrics.dtype  # float32, or float64 for a float64 twin of the mode
    misfit = torch.zeros((), dtype=dt, device=colloc.device)
    if kind == "admm":
        u, u_x, u_t, u_xx = mlp_taylor_2_reference(spec, net, new)
        f = u_t + lam1 * u * u_x - lam2 * u_xx
        z_new = soft_threshold(f + dual / rho, threshold)
        dual.copy_(dual + rho * (f - z_new))
        z.copy_(z_new)
        misfit = torch.mean(torch.abs(f - z_new))
    if not fixed:
        colloc.copy_(new)
    data_term = data_misfit(mlp_apply_reference(spec, net, x_data), u_data, "mse_sum", n_u)
    f_val = f_in[0].to(dt)
    scalar = lambda v: torch.tensor(v, dtype=dt, device=colloc.device)  # noqa: E731
    # METRIC_KEYS order: admm_misfit, data_term, lambda1, lambda2, lbfgs_iters, loss, res_term
    metrics[row] = torch.stack([misfit, data_term, scalar(lam1), scalar(lam2),
                                iters_in[0].to(dt), f_val, f_val - data_term])
    cursor += 1


def loss_and_grad_reference(
    spec: MLPSpec, net: Params, x_data, u_data, colloc, z, dual, *,
    kind: str, lam1: float, lam2: float, rho: float, explicit_inner: bool = False,
):
    """The fused step's loss and gradient by its own algorithm, in plain
    PyTorch: Taylor-2 forward keeping the pre-activation streams, the residual
    and data seeds, and the hand-written reverse mode of the recurrence.

    Returns (loss, data_term, res_term, grads) with grads a list
    [dW_0, db_0, dW_1, ...] shaped like the params.
    """
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    n_u, n_f = x_data.shape[0], colloc.shape[0]
    u, u_x, u_t, u_xx = mlp_taylor_2_reference(spec, net, colloc)
    f = u_t + lam1 * u * u_x - lam2 * u_xx
    if kind == "admm":
        q = f - z + dual / rho
        gf = rho * q + (dual if explicit_inner else 0.0)
        res_term = 0.5 * rho * torch.sum(q * q) + (torch.sum(dual * f) if explicit_inner else 0.0)
    elif kind == "l1_sq_norm":
        s = torch.sum(torch.abs(f))
        gf = 2.0 * s * torch.sign(f) / n_f
        res_term = s * s / n_f
    elif kind in ("mean_sq", "l2_sq_norm"):
        gf = 2.0 * f / n_f
        res_term = torch.sum(f * f) / n_f
    else:
        raise ValueError(f"unknown residual kind {kind!r}")
    seeds = (gf * lam1 * u_x, gf * lam1 * u, gf, -lam2 * gf)
    g_res = taylor2_backward_reference(spec, net, colloc, seeds)
    ud, _, _, _ = mlp_taylor_2_reference(spec, net, x_data)
    d = ud - u_data
    zero = torch.zeros_like(d)
    g_dat = taylor2_backward_reference(spec, net, x_data, (2.0 * d / n_u, zero, zero, zero))
    data_term = torch.sum(d * d) / n_u
    grads = [a + b for a, b in zip(g_res, g_dat)]
    shaped = []
    for i, layer in enumerate(net):
        shaped += [grads[2 * i].reshape(layer["W"].shape), grads[2 * i + 1].reshape(layer["b"].shape)]
    return data_term + res_term, data_term, res_term, shaped


def wide_loss_and_grad_reference(
    spec: MLPSpec, net: Params, x_data, u_data, colloc, z, dual, *,
    kind: str, lam1: float, lam2: float, rho: float, explicit_inner: bool = False,
):
    """The wide design's loss and gradient by its own algorithm, in plain
    PyTorch, for any widths (the plan of a wide net of these widths):

    - one stacked batch: the collocation points padded to ``nf_pad``, then
      the data points padded to ``nu_pad``, each segment its four streams
      one after another; every stacked input carries the bias's indicator
      column (1 on value rows), so that a layer is one product with
      [W; b];
    - the forward as those products, keeping every hidden layer's
      pre-activation streams; the head's (u, u_x, u_t, u_xx) on every row;
    - the seeds: dL/df of a collocation point by the kind (2 sign(f) / N_f
      for ``l1_sq_norm``), 2 (u - u_data) / N_u on a data point's value row,
      exactly 0 on its derivative rows and on padded points;
    - per layer, head first: dW as the split partials H^T G over the plan's
      row chunks, db as per-tile sums of the value rows' adjoints, gH = G W^T
      through the tanh rules;
    - the reductions in double, in a fixed order: the collocation splits and
      tiles apart from the data ones, g = S res + dat for ``l1_sq_norm``
      (S = sum |f| from the loss's per-tile sums) and res + dat otherwise.

    Returns (loss, data_term, res_term, grads) as
    :func:`loss_and_grad_reference`; the sums that the kernel takes in
    double are double here too.
    """
    from pinns_tpu_torch.models.mlp import input_scale, normalize_inputs

    layers = spec.layers
    n_f, n_u = colloc.shape[0], x_data.shape[0]
    plan = _wide_plan(layers, n_f, n_u)
    nf, nu = plan.nf_pad, plan.nu_pad
    dt = colloc.dtype
    tiles_f, tiles = nf // EW_TILE, (nf + nu) // EW_TILE
    sizes = (nf,) * 4 + (nu,) * 4  # the eight blocks of rows: (segment, stream)

    def pad(t, n):
        return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])

    def blocks(m):
        """[[4 stream blocks of the collocation segment], [... of the data one]]."""
        b = torch.split(m, sizes)
        return [list(b[:4]), list(b[4:])]

    def stack(segs):
        return torch.cat(segs[0] + segs[1])

    def act(p):
        """The tanh Taylor rule, segment by segment: H from P."""
        out = []
        for a, ax, at, axx in blocks(p):
            s = torch.tanh(a)
            d1 = 1.0 - s * s
            d2 = -2.0 * s * d1
            out.append([s, d1 * ax, d1 * at, d2 * ax * ax + d1 * axx])
        return stack(out)

    ind = stack([[torch.ones(nf, 1, dtype=dt)] + [torch.zeros(nf, 1, dtype=dt)] * 3,
                 [torch.ones(nu, 1, dtype=dt)] + [torch.zeros(nu, 1, dtype=dt)] * 3])
    scale = input_scale(spec, colloc.device).to(dt)
    zero2 = lambda n: torch.zeros(n, 2, dtype=dt)  # noqa: E731
    tangent = lambda n, k: zero2(n).index_fill(1, torch.tensor([k]), float(scale[k]))  # noqa: E731
    h = stack([[normalize_inputs(spec, pad(pts, n)), tangent(n, 0), tangent(n, 1), zero2(n)]
               for pts, n in ((colloc, nf), (x_data, nu))])
    wb = [torch.cat([layer["W"], layer["b"]]) for layer in net]
    hs, ps = [h], []
    for l in range(len(net) - 1):
        ps.append(torch.cat([hs[-1], ind], 1) @ wb[l])
        hs.append(act(ps[-1]))
    (u, ux, ut, uxx), (ud, _, _, _) = blocks(torch.cat([hs[-1], ind], 1) @ wb[-1])

    f = ut + lam1 * u * ux - lam2 * uxx
    if kind == "admm":
        q = f - pad(z, nf) + pad(dual, nf) / rho
        gf = rho * q + (pad(dual, nf) if explicit_inner else 0.0)
        val = 0.5 * rho * q * q + (pad(dual, nf) * f if explicit_inner else 0.0)
    elif kind == "l1_sq_norm":
        gf, val = 2.0 * torch.sign(f) / n_f, torch.abs(f)
    elif kind in ("mean_sq", "l2_sq_norm"):
        gf, val = 2.0 * f / n_f, f * f
    else:
        raise ValueError(f"unknown residual kind {kind!r}")
    live_f = (torch.arange(nf) < n_f).to(dt)[:, None]
    live_u = (torch.arange(nu) < n_u).to(dt)[:, None]
    gf, val = gf * live_f, val * live_f
    d = (ud - pad(u_data, nu)) * live_u
    zu = torch.zeros(nu, 1, dtype=dt)
    g = stack([[gf * lam1 * ux, gf * lam1 * u, gf, -lam2 * gf], [2.0 * d / n_u, zu, zu, zu]])

    def in_order(parts):
        total = torch.zeros_like(parts[0], dtype=torch.float64)
        for part in parts:
            total = total + part
        return total

    loss_part = torch.cat([val, d * d]).double().view(tiles, EW_TILE).sum(1)
    s_res, s_dat = in_order(loss_part[:tiles_f]), in_order(loss_part[tiles_f:])
    sr, splits_f = plan.split_rows, 4 * nf // plan.split_rows
    grads: List[torch.Tensor] = [None] * (2 * len(net))  # type: ignore[list-item]
    for l in range(len(net) - 1, -1, -1):
        split = [(hs[l][z * sr:(z + 1) * sr].T @ g[z * sr:(z + 1) * sr]).double()
                 for z in range(plan.splits)]
        value = torch.cat([blocks(g)[0][0], blocks(g)[1][0]]).double()
        per_tile = value.view(tiles, EW_TILE, -1).sum(1)
        for k, (res, dat) in enumerate(((in_order(split[:splits_f]), in_order(split[splits_f:])),
                                        (in_order(per_tile[:tiles_f]),
                                         in_order(per_tile[tiles_f:])))):
            total = s_res * res + dat if kind == "l1_sq_norm" else res + dat
            grads[2 * l + k] = total.to(dt).reshape(net[l]["b"].shape if k else net[l]["W"].shape)
        if l > 0:
            gh = g @ net[l]["W"].T
            out = []
            for (p, px, pt, pxx), (a, ax, at, axx) in zip(blocks(ps[l - 1]), blocks(gh)):
                s = torch.tanh(p)
                d1 = 1.0 - s * s
                d2 = -2.0 * s * d1
                gp = d1 * (a - 2.0 * s * (ax * px + at * pt + axx * pxx)
                           + (6.0 * s * s - 2.0) * axx * px * px)
                out.append([gp, ax * d1 + 2.0 * axx * d2 * px, at * d1, axx * d1])
            g = stack(out)
    s_f, data_term = s_res.to(dt), s_dat.to(dt) / n_u
    res_term = {"admm": s_f, "l1_sq_norm": s_f * s_f / n_f}.get(kind, s_f / n_f)
    return data_term + res_term, data_term, res_term, grads
