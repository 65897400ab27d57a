"""Wrappers of the fused MLP forward CUDA kernel and its backward
(``csrc/mlp_forward.cu``), bound as one ``torch.autograd.Function``, and the
backward's algorithm in plain PyTorch.

Replaces the TPU kernel ``mlp_forward_pallas`` (``_forward_kernel``;
``pinns_tpu/ops/pallas/fused_mlp.py`` at git ``89afc4b^``, lines 92-146):
u = W_L tanh(... tanh(W_0 normalize(x) + b_0) ...) + b_L. The TPU kernel had
no VJP; the port differentiates the data misfit on the card, so the backward
(cotangent of u -> dW, db) is a hand-written kernel too. The plain version of
the forward is ``models.mlp.mlp_apply_reference``, of the backward
:func:`mlp_backward_reference`.

Two designs, picked by :func:`design` from the widths (the header of
``csrc/mlp_forward.cu`` has both and what bounds them on the H100):

- "narrow", every width at most NARROW_WIDTH (the 8x20 nets of
  ``burgers_forward`` and ``abgrall_admm``): one launch forward, a per-tile
  kernel that keeps the activations in shared memory; the backward recomputes
  the forward per tile and reduces per-block partial gradients in block order
  (:func:`forward_config`, :func:`backward_config`);
- "wide", any wider net (``burgers_scale``'s 8x200, the Euler trunk
  2x200x5x3): the whole call, layer by layer, as register-tiled products on
  K2's engine (``csrc/layer_gemm.cuh``), with a block tile that the plan picks
  from the number of points so that a call of 100 points spreads over many
  SMs (:func:`mlp_forward_plan`, :func:`mlp_backward_plan`).

The wide design takes Fourier features (``spec.fourier``) and shock-path
features (``spec.n_paths``): its input pass computes each point's features
from B and from ``path_c`` and ``path_a`` (``csrc/fourier.cuh``) and its
backward the paths' gradient (``csrc/paths.cuh``); the flat params and
gradient hold the trunk's leaves, then the paths' (``taylor2.net_leaves``).
Such a net takes the wide design at any width; the narrow design refuses
it.

The float64 mode (``polish``'s data term and evaluation on the card): a
float64 spec on the narrow design takes its forward and backward
instantiated on double (``pinns_mlp_forward_f64``, ``pinns_mlp_backward_f64``;
:func:`forward_config` and :func:`backward_config` with ``itemsize`` 8),
under the same ``torch.autograd.Function``. The wide design, features and
paths in float64 raise ``taylor2.check_float64``'s refusal, naming the later
slice.

Both are bit-for-bit repeatable (no atomics). The wrappers validate what the
kernels assume and raise otherwise; on a CPU tensor they raise too. They
never fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import List, Sequence, Tuple

import torch

from pinns_tpu_torch.models.mlp import (
    MLPSpec,
    Params,
    embed_inputs,
    normalize_inputs,
    path_backward_reference,
)
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels.taylor2 import (
    check_call,
    check_float64,
    check_paths,
    feature_args,
    net_from_leaves,
    net_leaves,
    pack_params,
    refuse_features,
    split_grad,
)

LAUNCHES = 0  # forward kernel launches in this process (chip_smoke.py reads it)
BACKWARD_LAUNCHES = 0  # backward calls (kernel + reduction) in this process
F64_LAUNCHES = 0  # launches of the float64 mode's forward (the narrow design in double)
F64_BACKWARD_LAUNCHES = 0  # calls of the float64 mode's backward (kernel + reduction)
_launches_lock = threading.Lock()

MAX_WIDTH = 256
MAX_LAYERS = 32
NARROW_WIDTH = 32  # a net whose widths are all at most this takes the narrow design
# the narrow design
_POINTS_PER_THREAD = 4
_FWD_SMEM = 112 * 1024  # two forward blocks per H100 SM
_BWD_SMEM = 200 * 1024
_FWD_MAX_TILE = 128
_BWD_MAX_TILE = 64
_FWD_MAX_THREADS = 640  # the forward kernel's __launch_bounds__
_FWD_MAX_THREADS_F64 = 256  # the float64 mode's (kFwdThreadsF64)
MAX_GRID = 264  # backward blocks: two per SM of an H100
# the wide design: points padded to a multiple of EW_TILE (the row tile of
# the elementwise passes and of db's per-tile sums); the products' block tile
# SMALL_TILE (32 x 32, 64 threads) unless the hidden layers' products cut
# into LARGE_TILE (128 x 128, 256 threads: K2's) tiles give at least
# LARGE_TILE_MIN_BLOCKS blocks, about one an SM (at width 200 from 8,192
# points: scripts/k5_tile_sweep.py, PERF.md). dW's sum over the rows is
# split into chunks of whole SPLIT_STEP rows, at most MAX_SPLIT_ROWS (no
# float32 chain longer than 1,024 rows), enough of them that the widest
# layer's dW takes about SPLIT_BLOCKS blocks; where gH = G W^T has fewer
# blocks than that on the small tile, its sum over the layer's width is split
# too, into at most MAX_GH_SPLITS chunks that the next elementwise pass adds up
EW_TILE = 128
SMALL_TILE = 32
LARGE_TILE = 128
LARGE_TILE_MIN_BLOCKS = 128
SPLIT_BLOCKS = 396
SPLIT_STEP = 32
MAX_SPLIT_ROWS = 1024
MAX_GH_SPLITS = 4


def design(layers: Sequence[int]) -> str:
    """"narrow" or "wide": the K5 design that a net of these widths
    (``spec.widths``) takes; a first width above 2 (Fourier or path
    features) takes the wide one."""
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"mlp_forward kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    return "narrow" if wmax <= NARROW_WIDTH and layers[0] == 2 else "wide"


def _tile(layers: Sequence[int], buffers: int, budget: int, cap: int, itemsize: int = 4) -> int:
    """Largest multiple of 4 points (at most ``cap``) whose ``buffers``
    activation buffers (widest rows x (tile + 4) values of ``itemsize``
    bytes) fit ``budget``."""
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"mlp_forward kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    tile = budget // (itemsize * buffers * wmax) - 4
    return min(cap, tile - tile % _POINTS_PER_THREAD)


def forward_config(layers: Sequence[int], itemsize: int = 4) -> Tuple[int, int]:
    """(points per block, threads per block) of the forward kernel: one thread
    per (unit, 4-point group) of the widest layer, up to 640 (256 in the
    float64 mode, ``itemsize`` 8)."""
    tile = _tile(layers, 2, _FWD_SMEM, _FWD_MAX_TILE, itemsize)
    items = (tile // _POINTS_PER_THREAD) * max(layers[1:])
    cap = _FWD_MAX_THREADS if itemsize == 4 else _FWD_MAX_THREADS_F64
    return tile, min(cap, -(-items // 32) * 32)


def backward_config(layers: Sequence[int], n: int, itemsize: int = 4) -> Tuple[int, int]:
    """(points per tile, blocks) of the backward kernel for n points."""
    tile = _tile(layers, 3, _BWD_SMEM, _BWD_MAX_TILE, itemsize)
    return tile, max(1, min(MAX_GRID, -(-n // tile)))


def smem_bytes(layers: Sequence[int], tile: int, buffers: int, itemsize: int = 4) -> int:
    return itemsize * buffers * max(layers) * (tile + 4)


def _ld_h(width: int) -> int:
    """The row pitch of a layer input of this width: its columns, the bias's
    indicator, padded to 4 floats (``ld_h`` in the kernel)."""
    return (width + 4) // 4 * 4


def _align4(floats: int) -> int:
    return -(-floats // 4) * 4


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """How the wide design lays out a call of n points: the points padded to
    ``n_pad`` (a multiple of EW_TILE), the products' block ``tile``, dW's sum
    over the n_pad rows cut into ``splits`` chunks of ``split_rows`` (the
    last one shorter), gH's over a layer's width into ``gh_splits`` chunks
    (all three 0 in a forward plan), and the parts of its float32 scratch (in
    floats, each rounded up to 16 bytes, in the kernel's order): db's
    per-tile sums (doubles), the input H_0 = [x^, t^, (path features), 1,
    0 ...], the hidden outputs (every layer's in a backward plan, two
    ping-pong buffers in a forward plan), the adjoints G and gH's partials,
    dW's split partials, the path gradient's per-tile partials (doubles). The
    kernel lays the scratch out itself and refuses a plan that does not fit
    it."""

    tile: int
    n_pad: int
    split_rows: int
    splits: int
    gh_splits: int
    sums: int
    h0: int
    hidden: int
    gbuf: int
    partials: int
    psums: int = 0

    @property
    def scratch_floats(self) -> int:
        return self.sums + self.h0 + self.hidden + self.gbuf + self.partials + self.psums

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def _wide_layout(layers: Sequence[int], n: int) -> Tuple[Tuple[int, ...], int, int]:
    layers = tuple(int(w) for w in layers)
    design(layers)  # the width limit
    n_pad = max(1, -(-n // EW_TILE)) * EW_TILE
    hidden = layers[1:-1] or layers
    blocks = (n_pad // LARGE_TILE) * -(-max(hidden) // LARGE_TILE)
    return layers, n_pad, LARGE_TILE if blocks >= LARGE_TILE_MIN_BLOCKS else SMALL_TILE


def mlp_forward_plan(layers: Sequence[int], n: int) -> WidePlan:
    """The wide forward's plan for ``n`` points through a net of these widths
    (``layers[0]`` the first layer's input width, ``spec.widths``)."""
    layers, n_pad, tile = _wide_layout(layers, n)
    return WidePlan(tile=tile, n_pad=n_pad, split_rows=0, splits=0, gh_splits=0, sums=0,
                    h0=n_pad * _ld_h(layers[0]), hidden=2 * n_pad * _ld_h(max(layers)), gbuf=0,
                    partials=0)


def mlp_backward_plan(layers: Sequence[int], n: int, path_params: int = 0) -> WidePlan:
    """The wide backward's plan for ``n`` points through a net of these
    widths (``layers[0]`` the first layer's input width, ``spec.widths``)
    and ``path_params`` path parameters (``spec.n_path_params``)."""
    layers, n_pad, tile = _wide_layout(layers, n)
    pairs = list(zip(layers[:-1], layers[1:]))
    steps = n_pad // SPLIT_STEP
    pieces = max(-(-din // tile) * -(-dout // tile) for din, dout in pairs)
    per_split = min(MAX_SPLIT_ROWS // SPLIT_STEP, -(-steps // -(-SPLIT_BLOCKS // pieces)))
    splits = -(-steps // per_split)
    gh_blocks = -(-n_pad // tile) * -(-max(layers[1:-1] or (1,)) // tile)
    gh_splits = max(1, min(MAX_GH_SPLITS, SPLIT_BLOCKS // gh_blocks)) if tile == SMALL_TILE else 1
    n_params = sum(din * dout + dout for din, dout in pairs)
    return WidePlan(
        tile=tile, n_pad=n_pad, split_rows=per_split * SPLIT_STEP, splits=splits,
        gh_splits=gh_splits, sums=_align4(2 * (len(layers) - 1) * (n_pad // EW_TILE) * max(layers)),
        h0=n_pad * _ld_h(layers[0]), hidden=sum(n_pad * _ld_h(w) for w in layers[1:-1]),
        gbuf=(1 + gh_splits) * n_pad * max(layers), partials=_align4(splits * n_params),
        psums=_align4(2 * (n_pad // EW_TILE) * path_params))


def _lib():
    lib = build.load_library("mlp_forward")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pinns_mlp_forward.argtypes = [p, i, p, p, i, f, f, f, f, i, i, p, i, p]
        lib.pinns_mlp_forward.restype = i
        lib.pinns_mlp_backward.argtypes = [p, i, p, p, i, f, f, f, f, i, i, p, p, p, p, i, p]
        lib.pinns_mlp_backward.restype = i
        q = ctypes.c_longlong
        lib.pinns_mlp_forward_wide.argtypes = [  # taylor2.feature_args after n_layers
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, p, q, p, i, p,
        ]
        lib.pinns_mlp_forward_wide.restype = i
        lib.pinns_mlp_backward_wide.argtypes = [
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, i, i, i, p, p, q, p, i, p,
        ]
        lib.pinns_mlp_backward_wide.restype = i
        d = ctypes.c_double
        lib.pinns_mlp_forward_f64.argtypes = [p, i, p, p, i, d, d, d, d, i, i, p, i, p]
        lib.pinns_mlp_forward_f64.restype = i
        lib.pinns_mlp_backward_f64.argtypes = [p, i, p, p, i, d, d, d, d, i, i, p, p, p, p, i, p]
        lib.pinns_mlp_backward_f64.restype = i
        lib.pinns_mlp_error_string.argtypes = [i]
        lib.pinns_mlp_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def _check_spec(spec: MLPSpec) -> None:
    check_float64("mlp_forward", spec)
    if len(spec.layers) - 1 > MAX_LAYERS:
        raise ValueError(f"mlp_forward kernel takes up to {MAX_LAYERS} layers")
    if design(spec.widths) == "narrow":
        refuse_features("mlp_forward (narrow design)", spec,
                        "such a net takes the wide design (mlp_forward.design)")
    check_paths("mlp_forward", spec)


def _raise(lib, err: int, what: str, **cfg) -> None:
    msg = lib.pinns_mlp_error_string(err).decode()
    raise RuntimeError(f"mlp_forward {what} launch failed: CUDA error {err} ({msg}); {cfg}")


def mlp_forward(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """u = MLP(x), (N, out_dim) float32, from one host call: one kernel launch
    (narrow design) or the wide design's layer products. ``x`` is the (N, 2)
    float32 raw points, contiguous on a CUDA device; ``params`` the
    JAX-layout layers on the same device. Raises on anything else."""
    global LAUNCHES, F64_LAUNCHES
    _check_spec(spec)
    check_call("mlp_forward", spec, params, x)
    layers = spec.widths
    wide = design(layers) == "wide"
    f64 = spec.dtype == torch.float64  # the float64 mode (narrow: check_float64)
    n = x.shape[0]
    u = torch.empty((n, spec.out_dim), dtype=spec.dtype if f64 else torch.float32,
                    device=x.device)
    if n == 0:
        return u
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    box = (spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wide:
        plan = mlp_forward_plan(layers, n)
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
        err = lib.pinns_mlp_forward_wide(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *feature_args(spec), *box,
            plan.n_pad,
            plan.tile, scratch.data_ptr(), plan.scratch_floats, u.data_ptr(),
            x.device.index or 0, stream)
    else:
        item = 8 if f64 else 4
        tile, threads = forward_config(layers, item)
        entry = lib.pinns_mlp_forward_f64 if f64 else lib.pinns_mlp_forward
        err = entry(x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *box, tile, threads,
                    u.data_ptr(), x.device.index or 0, stream)
    if err != 0:
        _raise(lib, err, "forward", **(dataclasses.asdict(plan) if wide else {
            "tile": tile, "threads": threads, "smem": smem_bytes(layers, tile, 2, item)}))
    with _launches_lock:
        if f64:
            F64_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return u


def mlp_backward(spec: MLPSpec, params: Params, x: torch.Tensor,
                 g_out: torch.Tensor) -> torch.Tensor:
    """The flat gradient (``pack_params`` order, a shock-path net's path
    leaves after the trunk's) of sum over points of g_out . MLP(x), from one
    host call: the backward kernel and its
    block-order reduction (narrow design) or the wide design's layer products
    and fixed-order reduction. ``g_out`` is (N, out_dim) float32, contiguous,
    on ``x``'s device."""
    global BACKWARD_LAUNCHES, F64_BACKWARD_LAUNCHES
    _check_spec(spec)
    check_call("mlp_forward backward", spec, params, x, g_out)
    layers = spec.widths
    wide = design(layers) == "wide"
    f64 = spec.dtype == torch.float64  # the float64 mode (narrow: check_float64)
    n = x.shape[0]
    grad = torch.empty(spec.n_params, dtype=torch.float64 if f64 else torch.float32,
                       device=x.device)
    if n == 0:
        return grad.zero_()
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    box = (spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wide:
        plan = mlp_backward_plan(layers, n, spec.n_path_params)
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
        err = lib.pinns_mlp_backward_wide(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *feature_args(spec), *box,
            plan.n_pad,
            plan.tile, plan.split_rows, plan.splits, plan.gh_splits, g_out.data_ptr(),
            scratch.data_ptr(),
            plan.scratch_floats, grad.data_ptr(), x.device.index or 0, stream)
    else:
        item = 8 if f64 else 4
        tile, grid = backward_config(layers, n, item)
        partials = torch.empty((grid, spec.n_params), dtype=grad.dtype, device=x.device)
        hstore = torch.empty(grid * (len(layers) - 2) * max(layers) * tile,
                             dtype=grad.dtype, device=x.device)
        entry = lib.pinns_mlp_backward_f64 if f64 else lib.pinns_mlp_backward
        err = entry(x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *box, tile, grid,
                    g_out.data_ptr(), partials.data_ptr(), hstore.data_ptr(), grad.data_ptr(),
                    x.device.index or 0, stream)
    if err != 0:
        _raise(lib, err, "backward", **(dataclasses.asdict(plan) if wide else {
            "tile": tile, "grid": grid, "smem": smem_bytes(layers, tile, 3, item)}))
    with _launches_lock:
        if f64:
            F64_BACKWARD_LAUNCHES += 1
        else:
            BACKWARD_LAUNCHES += 1
    return grad


class _MLPForward(torch.autograd.Function):
    """K5 forward, K5 backward as its VJP (w.r.t. the params only)."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        return mlp_forward(spec, net_from_leaves(leaves, spec.n_paths), x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        x, *leaves = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the mlp_forward kernel's backward gives no gradient "
                                      "with respect to the input points")
        params = net_from_leaves(leaves, ctx.spec.n_paths)
        grad = mlp_backward(ctx.spec, params, x, g_out.contiguous())
        return (None, None, *split_grad(grad, leaves))


def mlp_apply_kernel(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """u = MLP(x) through K5, differentiable in the params through the K5
    backward (shock paths included, wide design). CUDA tensors only (the
    wrappers raise on anything else)."""
    return _MLPForward.apply(spec, x, *net_leaves(params))


def mlp_backward_reference(spec: MLPSpec, params: Params, x: torch.Tensor,
                           g_out: torch.Tensor) -> List[torch.Tensor]:
    """The backward kernel's algorithm in plain PyTorch: [dW_0, db_0, dW_1,
    ...] shaped like the params, then d path_c and d path_a for a shock-path
    net (``taylor2.net_leaves`` order), of sum over points of g_out . MLP(x).
    The paths' gradient applies ``models.mlp.path_backward_reference`` to
    the path columns of layer 0's input adjoints G_0 W_0^T."""
    h = normalize_inputs(spec, x)
    acts = [embed_inputs(spec, h, params[0])]  # the input of every layer
    for layer in params[:-1]:
        acts.append(torch.tanh(acts[-1] @ layer["W"] + layer["b"]))
    grads: List[torch.Tensor] = [None] * (2 * len(params))  # type: ignore[list-item]
    g = g_out
    for l in range(len(params) - 1, -1, -1):
        grads[2 * l] = acts[l].T @ g
        grads[2 * l + 1] = g.sum(dim=0, keepdim=True)
        if l > 0:
            g = (1.0 - acts[l] * acts[l]) * (g @ params[l]["W"].T)
    if spec.n_paths:
        w_paths = params[0]["W"][2 + 2 * spec.n_fourier:]  # the path features' rows of W_0
        grads += list(path_backward_reference(spec, params[0], h, g @ w_paths.T))
    return grads
