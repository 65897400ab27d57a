"""Wrapper of K7a, the Taylor-1 streams of the tanh MLP and their backward
(``csrc/taylor1.cu``), bound as one ``torch.autograd.Function``, and the
backward's algorithm in plain PyTorch.

K7a computes (y, y_x, y_t), each (N, out_dim) float32, for N points (N, 2):
the value stream s = tanh(p) and the derivative streams h_d = (1 - s^2) p_d
through every hidden layer, the bias on the value stream only, the input
rescale's chain rule on the first layer. It replaces the XLA program of
``pinns_tpu/ops/taylor.py::mlp_taylor_1`` (``:91-129``; JAX had no Pallas
kernel for it), which carries the strong Euler residual at every collocation
and served point. Its plain versions are ``ops.taylor.mlp_taylor_1_reference``
(forward) and :func:`taylor1_backward_reference` (the reverse mode, also in
float64).

Two designs, picked by :func:`taylor1_plan` from the widths and the paths
(the header of ``csrc/taylor1.cu`` has the rest and what bounds them on the
H100):

- "wide", any net wider than 32 and every shock-path net: whole-call layer
  products on the engine of ``csrc/layer_gemm.cuh``, the three streams stacked
  stream-major into one (3 n_pad x width) matrix per layer with the bias's
  indicator column (1 on value rows, 0 on derivative rows), each product's
  block tile holding the value, x and t sums of the same points, so the tanh
  rule runs in its epilogue (forward) and its adjoint in gH's (backward):
  L + 1 launches forward, 2 L + 2 backward (one more with paths). The plan
  picks the block tile from the number of points (K5's rule: 32 x 32 until
  the products give about one 128 x 128 block an SM), dW's split and the
  scratch.
- "narrow", every width at most 32 and no paths (the 8x20 nets): K1's
  per-tile kernel with three streams, one launch forward; the backward a
  per-tile kernel and a fixed-order reduction, two launches.

Each output's float32 sum is the same in both, so their forwards agree bit
for bit. The wrappers take a ``design`` argument that only tests and
``chip_smoke.py`` pass, to hold the two against each other.

Fourier features (``spec.fourier``) and shock-path features
(``spec.n_paths``) ride in the wide design's input pass: each point's
first-layer input carries them and their x and t streams, computed from B
and from ``path_c`` and ``path_a`` (``csrc/fourier.cuh``), and the backward
gives the paths' gradient too (the header of ``csrc/taylor1.cu``,
``csrc/paths.cuh``). The flat params and gradient hold the trunk's leaves,
then ``path_c`` and ``path_a`` (``taylor2.net_leaves``).

It takes float32 specs only: a mixed stream policy raises, naming the slice
that would bring it. The wrappers validate what the kernels assume and raise
otherwise; they never fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import List, Sequence, Tuple

import torch

from pinns_tpu_torch.device import raw_stream
from pinns_tpu_torch.models.mlp import (
    MLPSpec,
    Params,
    embed_streams,
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
    split_grad,
)
from pinns_tpu_torch.ops.taylor import _StreamPolicy, taylor1_layer

LAUNCHES = 0  # K7a forward calls in this process, both designs (chip_smoke.py reads it)
BACKWARD_LAUNCHES = 0  # K7a backward calls (one host call issues all its launches)
NARROW_LAUNCHES = 0  # of those, the narrow design's forward calls
NARROW_BACKWARD_LAUNCHES = 0  # and its backward calls
_launches_lock = threading.Lock()  # HTTP handler threads launch concurrently

STREAMS = 3
MAX_WIDTH = 256
MAX_LAYERS = 32
DESIGNS = ("wide", "narrow")
# the wide design: points padded to a multiple of EW_TILE (the row tile of
# the input and path passes), so that a product's row tile lies in one
# stream; the block tile SMALL_TILE (32 x 32, 64 threads) unless the hidden
# products cut into LARGE_TILE (128 x 128, 256 threads) tiles give at least
# LARGE_TILE_MIN_BLOCKS blocks (K5's rule); gH's three-stream tiles, which
# share a launch with dW's, take GRAD_TILE_POINTS points at either tile
# (db's per-tile sums follow them); dW's sum over the stacked rows split into
# chunks of whole SPLIT_STEP rows, at most MAX_SPLIT_ROWS, enough of them
# that the widest layer's dW takes about SPLIT_BLOCKS blocks (K3's target:
# short float32 chains)
EW_TILE = 128
SMALL_TILE = 32
LARGE_TILE = 128
GRAD_TILE_POINTS = 32
LARGE_TILE_MIN_BLOCKS = 128
SPLIT_BLOCKS = 1600
SPLIT_STEP = 32
MAX_SPLIT_ROWS = 1024
# the narrow design: a net whose widths are all at most NARROW_WIDTH, without
# paths; forward tiles of up to NARROW_MAX_TILE points whose two
# three-stream buffers fit NARROW_SMEM (K1's), at most NARROW_MAX_THREADS
# threads; backward tiles of up to NARROW_BWD_MAX_TILE points whose three
# buffer triples fit NARROW_BWD_SMEM, at most NARROW_MAX_GRID blocks (K5's)
NARROW_WIDTH = 32
NARROW_SMEM = 112 * 1024
NARROW_MAX_TILE = 128
NARROW_MAX_THREADS = 640
NARROW_BWD_SMEM = 200 * 1024
NARROW_BWD_MAX_TILE = 64
NARROW_MAX_GRID = 264
POINTS_PER_THREAD = 4


def _ld_h(width: int) -> int:
    """The row pitch of a stacked input of this width: its columns, the
    bias's indicator, padded to 4 floats (``ld_h`` in the kernel)."""
    return (width + 4) // 4 * 4


def _align4(floats: int) -> int:
    return -(-floats // 4) * 4


@dataclasses.dataclass(frozen=True)
class Taylor1Plan:
    """How K7a lays out a call of n points.

    ``design`` "wide": the points padded to ``n_pad``, dW's block ``tile``
    (32 or 128), dW's sum over the 3 n_pad stacked rows cut into ``splits``
    chunks of ``split_rows`` (0 and 0 in a forward plan), and the parts of its
    float32 scratch (in floats, each rounded up to 16 bytes, in the kernel's
    order): db's per-tile sums (doubles, one per three-stream tile of
    points), the stacked input streams H_0, the stacked inputs ``hbuf`` (two
    ping-pong buffers in a forward plan, every hidden layer's outputs in a
    backward plan, which applies the rule's adjoint at them), two adjoint
    buffers, the split partials and the path gradient's per-128-point
    partials (doubles).

    ``design`` "narrow": ``tile`` points a block, ``threads`` a forward block,
    ``grid`` backward blocks; the scratch (backward only) holds the blocks'
    partials and their kept hidden output streams (``hbuf``).

    ``launches`` is the kernel launches of one host call. The kernel lays the
    scratch out itself and refuses a plan that does not fit it."""

    design: str
    tile: int
    n_pad: int
    split_rows: int
    splits: int
    sums: int
    h0: int
    hbuf: int
    gbuf: int
    partials: int
    psums: int = 0
    threads: int = 0
    grid: int = 0
    launches: int = 0

    @property
    def parts(self) -> Tuple[int, ...]:
        """The scratch's parts in the kernel's order (floats)."""
        if self.design == "narrow":
            return (self.partials, self.hbuf)
        return (self.sums, self.h0, self.hbuf, self.gbuf, self.partials, self.psums)

    @property
    def scratch_floats(self) -> int:
        return sum(self.parts)

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def default_design(layers: Sequence[int]) -> str:
    """"narrow" or "wide": the K7a design that a net of these widths takes
    (``layers[0]`` 2 + 2F + K: a net with Fourier or path features takes the
    wide one)."""
    layers = tuple(int(w) for w in layers)
    return "narrow" if layers[0] == 2 and max(layers) <= NARROW_WIDTH else "wide"


def _narrow_plan(layers: Tuple[int, ...], n: int, backward: bool) -> Taylor1Plan:
    wmax = max(layers)
    if not backward:
        tile = NARROW_SMEM // (4 * 2 * STREAMS * wmax) - 4
        tile = min(NARROW_MAX_TILE, tile - tile % POINTS_PER_THREAD)
        items = (tile // POINTS_PER_THREAD) * max(layers[1:])
        threads = min(NARROW_MAX_THREADS, -(-items // 32) * 32)
        return Taylor1Plan(design="narrow", tile=tile, n_pad=-(-n // tile) * tile, split_rows=0,
                           splits=0, sums=0, h0=0, hbuf=0, gbuf=0, partials=0,
                           threads=threads, grid=-(-n // tile), launches=1)
    tile = NARROW_BWD_SMEM // (4 * 3 * STREAMS * wmax) - 4
    tile = min(NARROW_BWD_MAX_TILE, tile - tile % POINTS_PER_THREAD)
    grid = max(1, min(NARROW_MAX_GRID, -(-n // tile)))
    n_params = sum(din * dout + dout for din, dout in zip(layers[:-1], layers[1:]))
    return Taylor1Plan(
        design="narrow", tile=tile, n_pad=-(-n // tile) * tile, split_rows=0, splits=0,
        sums=0, h0=0, hbuf=_align4(grid * (len(layers) - 2) * STREAMS * wmax * tile), gbuf=0,
        partials=_align4(grid * n_params), grid=grid, launches=2)


def taylor1_plan(layers: Sequence[int], n: int, backward: bool = False,
                 path_params: int = 0, design: str = None) -> Taylor1Plan:
    """K7a's plan for ``n`` points through a net of these widths (the
    forward's, or the backward's with ``backward``). ``layers[0]`` is the
    first layer's input width (``spec.widths``: 2 + the number of paths);
    ``path_params`` the paths' parameter count (``spec.n_path_params``);
    ``design`` None for the one the widths pick (:func:`default_design`), or a
    design to hold against the other (the narrow one only where the widths
    allow it). Plans are cached: a call computes each shape's once."""
    return _plan(tuple(int(w) for w in layers), int(n), bool(backward), int(path_params),
                 design)


@functools.lru_cache(maxsize=512)
def _plan(layers: Tuple[int, ...], n: int, backward: bool, path_params: int,
          design: str) -> Taylor1Plan:
    if max(layers) > MAX_WIDTH:
        raise ValueError(f"taylor1 kernel takes widths up to {MAX_WIDTH}, got {max(layers)}")
    if len(layers) - 1 > MAX_LAYERS:
        raise ValueError(f"taylor1 kernel takes up to {MAX_LAYERS} layers")
    auto = default_design(layers)
    design = auto if design is None else design
    if design not in DESIGNS:
        raise ValueError(f"taylor1 designs are {DESIGNS}, got {design!r}")
    if design == "narrow":
        if auto != "narrow":
            raise ValueError(f"taylor1's narrow design takes nets without Fourier or path "
                             f"features whose widths are at most {NARROW_WIDTH}, got {layers}")
        return _narrow_plan(layers, n, backward)
    n_pad = max(1, -(-n // EW_TILE)) * EW_TILE
    rows = STREAMS * n_pad
    hidden = layers[1:-1] or layers
    blocks = (rows // LARGE_TILE) * -(-max(hidden) // LARGE_TILE)
    tile = LARGE_TILE if blocks >= LARGE_TILE_MIN_BLOCKS else SMALL_TILE
    wmax = max(layers)
    n_layers = len(layers) - 1
    h0 = rows * _ld_h(layers[0])
    if not backward:
        return Taylor1Plan(design="wide", tile=tile, n_pad=n_pad, split_rows=0, splits=0,
                           sums=0, h0=h0, hbuf=2 * rows * _ld_h(wmax), gbuf=0,
                           partials=0, launches=n_layers + 1)
    pairs = list(zip(layers[:-1], layers[1:]))
    steps = rows // SPLIT_STEP
    pieces = max(-(-din // tile) * -(-dout // tile) for din, dout in pairs)
    per_split = min(MAX_SPLIT_ROWS // SPLIT_STEP, -(-steps // -(-SPLIT_BLOCKS // pieces)))
    splits = -(-steps // per_split)
    n_params = sum(din * dout + dout for din, dout in pairs)
    tiles = n_pad // GRAD_TILE_POINTS
    return Taylor1Plan(
        design="wide", tile=tile, n_pad=n_pad, split_rows=per_split * SPLIT_STEP,
        splits=splits, sums=_align4(2 * n_layers * tiles * wmax), h0=h0,
        hbuf=rows * sum(_ld_h(w) for w in layers[1:-1]),
        gbuf=2 * rows * wmax, partials=_align4(splits * n_params),
        psums=_align4(2 * (n_pad // EW_TILE) * path_params),
        launches=2 * n_layers + 2 + (1 if path_params else 0))


def _lib():
    lib = build.load_library("taylor1")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.pinns_taylor1_forward.argtypes = [  # taylor2.feature_args after n_layers
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, p, q, p, p, p, i, p,
        ]
        lib.pinns_taylor1_forward.restype = i
        lib.pinns_taylor1_backward.argtypes = [
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, i, i, p, p, p, p, q, p, i, p,
        ]
        lib.pinns_taylor1_backward.restype = i
        lib.pinns_taylor1_narrow_forward.argtypes = [
            p, i, p, p, i, f, f, f, f, i, i, p, p, p, i, p,
        ]
        lib.pinns_taylor1_narrow_forward.restype = i
        lib.pinns_taylor1_narrow_backward.argtypes = [
            p, i, p, p, i, f, f, f, f, i, i, p, p, p, p, q, p, i, p,
        ]
        lib.pinns_taylor1_narrow_backward.restype = i
        lib.pinns_taylor1_error_string.argtypes = [i]
        lib.pinns_taylor1_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def check_spec(spec: MLPSpec) -> None:
    """Raise unless K7a takes ``spec``: float32 streams (``check_call``
    checks the dtypes of the tensors) and Fourier and path features within
    the kernel's bounds (``taylor2.check_paths``). A float64 spec raises
    ``taylor2.check_float64``'s refusal: K7a's float64 mode is later work."""
    check_float64("taylor1 (K7a)", spec, mode=False)
    if spec.mixed:
        raise ValueError(
            "the taylor1 kernel (K7a) takes float32 specs only; the mixed stream "
            "policy on the Taylor-1 streams is left to a later slice (ROADMAP queue 2, K7a)")
    check_paths("taylor1", spec)


def _raise(lib, err: int, what: str, plan: Taylor1Plan) -> None:
    msg = lib.pinns_taylor1_error_string(err).decode()
    raise RuntimeError(f"taylor1 {what} launch failed: CUDA error {err} ({msg}); {plan}")


def taylor1(spec: MLPSpec, params: Params, x: torch.Tensor, out=None, design: str = None,
            flat: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, y_x, y_t), each (N, out_dim) float32, from one host call of K7a's
    forward. ``x`` is the (N, 2) float32 raw points, contiguous on a CUDA
    device; ``params`` the JAX-layout layers on the same device. ``out``, if
    given, is the three contiguous (N, out_dim) float32 tensors to write (a
    served ensemble's member slices of one (E, N, out_dim) buffer each).
    ``flat``, if given, is ``params`` already packed in ``pack_params``
    order (a served ensemble's member row, which ``params`` views), read in
    place of packing them. ``design`` as :func:`taylor1_plan`'s. Raises on
    anything else."""
    global LAUNCHES, NARROW_LAUNCHES
    check_spec(spec)
    if out is None:
        outs = tuple(torch.empty((x.shape[0], spec.out_dim), dtype=torch.float32,
                                 device=x.device) for _ in range(STREAMS))
    else:
        outs = tuple(out)
        if len(outs) != STREAMS:
            raise ValueError(f"taylor1 writes {STREAMS} streams, got {len(outs)} outputs")
    check_call("taylor1", spec, params, x, *outs)
    layers = spec.widths
    n = x.shape[0]
    if n == 0:
        return outs
    plan = taylor1_plan(layers, n, design=design)
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    if flat is None:
        flat = pack_params(params)
    elif (flat.dtype != torch.float32 or flat.device != x.device or not flat.is_contiguous()
          or flat.numel() < spec.n_params):
        raise ValueError(f"taylor1: flat params must be a contiguous float32 vector of at least "
                         f"{spec.n_params} on {x.device}, got {flat.dtype} "
                         f"{tuple(flat.shape)} on {flat.device}")
    stream = raw_stream(x.device.index or 0)
    if plan.design == "narrow":
        err = lib.pinns_taylor1_narrow_forward(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, spec.lb[0], spec.lb[1],
            spec.ub[0], spec.ub[1], plan.tile, plan.threads, *(o.data_ptr() for o in outs),
            x.device.index or 0, stream)
    else:
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
        err = lib.pinns_taylor1_forward(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *feature_args(spec),
            spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], plan.n_pad, plan.tile,
            scratch.data_ptr(), plan.scratch_floats, *(o.data_ptr() for o in outs),
            x.device.index or 0, stream)
    if err != 0:
        _raise(lib, err, "forward", plan)
    with _launches_lock:
        LAUNCHES += 1
        NARROW_LAUNCHES += plan.design == "narrow"
    return outs


def taylor1_backward(spec: MLPSpec, params: Params, x: torch.Tensor,
                     cotangents: Sequence[torch.Tensor], design: str = None) -> torch.Tensor:
    """K7a's backward: the flat gradient (``pack_params`` order, the paths'
    leaves after the trunk's) of sum over
    points of gy . y + gyx . y_x + gyt . y_t, where ``cotangents`` = (gy, gyx,
    gyt), each (N, out_dim) float32, contiguous, on ``x``'s CUDA device. One
    host call that issues every launch of the plan's design (``taylor1_plan``;
    ``design`` as its); raises on anything the kernel does not take."""
    global BACKWARD_LAUNCHES, NARROW_BACKWARD_LAUNCHES
    if len(cotangents) != STREAMS:
        raise ValueError(f"taylor1 backward takes {STREAMS} stream cotangents, "
                         f"got {len(cotangents)}")
    check_spec(spec)
    check_call("taylor1 backward", spec, params, x, *cotangents)
    layers = spec.widths
    n = x.shape[0]
    grad = torch.empty(spec.n_params, dtype=torch.float32, device=x.device)
    if n == 0:
        return grad.zero_()
    plan = taylor1_plan(layers, n, backward=True, path_params=spec.n_path_params,
                        design=design)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    stream = raw_stream(x.device.index or 0)
    if plan.design == "narrow":
        err = lib.pinns_taylor1_narrow_backward(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, spec.lb[0], spec.lb[1],
            spec.ub[0], spec.ub[1], plan.tile, plan.grid, *(g.data_ptr() for g in cotangents),
            scratch.data_ptr(), plan.scratch_floats, grad.data_ptr(), x.device.index or 0,
            stream)
    else:
        err = lib.pinns_taylor1_backward(
            x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, *feature_args(spec),
            spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], plan.n_pad, plan.tile,
            plan.split_rows, plan.splits, *(g.data_ptr() for g in cotangents),
            scratch.data_ptr(), plan.scratch_floats, grad.data_ptr(), x.device.index or 0,
            stream)
    if err != 0:
        _raise(lib, err, "backward", plan)
    with _launches_lock:
        BACKWARD_LAUNCHES += 1
        NARROW_BACKWARD_LAUNCHES += plan.design == "narrow"
    return grad


class _Taylor1(torch.autograd.Function):
    """K7a's forward, its backward as the VJP (w.r.t. the params only).
    Saves only (x, params): the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        return taylor1(spec, net_from_leaves(leaves, spec.n_paths), x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        x, *leaves = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the taylor1 kernels give no gradient with respect "
                                      "to the input points")
        params = net_from_leaves(leaves, ctx.spec.n_paths)
        grad = taylor1_backward(ctx.spec, params, x, [g.contiguous() for g in cotangents])
        return (None, None, *split_grad(grad, leaves))


def mlp_taylor1_kernel(spec: MLPSpec, params: Params, x: torch.Tensor):
    """(y, y_x, y_t) through K7a, differentiable in the params through its
    backward (shock paths included). CUDA tensors only (the wrappers raise on
    anything else)."""
    return _Taylor1.apply(spec, x, *net_leaves(params))


def taylor1_backward_reference(spec: MLPSpec, net: Params, x: torch.Tensor,
                               cotangents) -> List[torch.Tensor]:
    """K7a's backward in plain PyTorch: [dW_0, db_0, dW_1, ...] (W leaves
    (din, dout), b leaves (1, dout)), then d path_c and d path_a for a
    shock-path net (``taylor2.net_leaves`` order), of sum over points of the
    cotangents (gy, gyx, gyt), each (N, out_dim), dotted with (y, y_x, y_t).
    It computes in ``spec.dtype`` (float64 with a float64 spec, params,
    points and cotangents). For a hidden layer with s = tanh p and output
    adjoints (gh, ghx, ght): gp = (1 - s^2) (gh - 2 s (ghx px + ght pt)),
    gpx = ghx (1 - s^2), gpt = ght (1 - s^2). The paths' gradient applies
    ``models.mlp.path_backward_reference`` to the path columns of layer 0's
    input adjoints G_0 W_0^T, one per stream (after the Fourier columns)."""
    pol = _StreamPolicy(spec)
    h = normalize_inputs(spec, x)
    n = x.shape[0]
    streams = tuple(t.expand(n, -1) for t in embed_streams(spec, h, net[0])[:STREAMS])
    saved = []  # (pre-activation streams, tanh factors) of each hidden layer
    inputs = [streams]
    for i, layer in enumerate(net[:-1]):
        pre, tanh, streams = taylor1_layer(pol, streams, layer["W"], layer["b"], i == 0)
        saved.append((pre, tanh))
        inputs.append(streams)
    grads: List[torch.Tensor] = [None] * (2 * len(net))  # type: ignore[list-item]
    G = tuple(g.reshape(n, -1) for g in cotangents)
    for l in range(len(net) - 1, -1, -1):
        X = inputs[l]
        grads[2 * l] = sum(X[s].T @ G[s] for s in range(STREAMS))
        grads[2 * l + 1] = G[0].sum(dim=0, keepdim=True)
        if l > 0:
            w = net[l]["W"]
            gh, ghx, ght = (g @ w.T for g in G)
            (_, px, pt), (s, sp) = saved[l - 1]
            G = (sp * (gh - 2.0 * s * (ghx * px + ght * pt)), ghx * sp, ght * sp)
    if spec.n_paths:
        w_paths = net[0]["W"][2 + 2 * spec.n_fourier:]  # the path features' rows of W_0
        grads += list(path_backward_reference(spec, net[0], h, *(g @ w_paths.T for g in G)))
    return grads
