"""Wrapper of the fused Taylor-2 CUDA kernel (``csrc/taylor2.cu``).

Replaces the TPU kernel ``mlp_taylor2_pallas`` (``_taylor2_kernel`` and the
lane-packed ``_taylor2_kernel_packed``; ``pinns_tpu/ops/pallas/fused_mlp.py``
at git ``89afc4b^``, lines 148-460). One launch computes (u, u_x, u_t, u_xx)
through the whole affine tanh MLP, keeping every activation stream in shared
memory; the plain PyTorch version is ``ops.taylor.mlp_taylor_2_reference``.

What bounds it on the H100: at width 200 the fp32 FMA issue rate (full fp32,
no tensor cores or TF32, by the numerics rule) and the shared-memory loads
that feed the FMAs; at width 20 and small N the launch and per-layer barrier
latency. Two designs answer, one launch a call each (:func:`launch_config`
picks one by the widths): above width 32 the TPU kernel's own layout, the
four streams of a 32-point tile stacked into one matrix in shared memory and
multiplied by each layer's weights, which arrive through a cp.async ring,
with 8 x 8 register tiles (64 FMAs per four 16-byte shared loads); at width
32 and below a per-tile kernel (16 FMAs per weight load, up to 128
points a block). The TPU kernel's lane packing has no counterpart: the
same kernels take every width up to 256.

The backward of K1, K2 (``csrc/taylor2_backward.cu``), turns the cotangents
of the four streams into dW and db. The TPU package had no kernel for it (its
custom-VJP op recomputed the Taylor pass in XLA, ``fused_mlp.py:391-418``);
the port differentiates the training residual on the card with it, outside
the fused Adam step. :func:`mlp_taylor2_kernel` binds K1 and K2 as one
``torch.autograd.Function``; the plain version of K2 is
:func:`taylor2_backward_reference`, the reverse mode that
``csrc/fused_step.cu`` also writes out. K2 runs the whole call layer by
layer as register-tiled float32 products over the four streams stacked into
one matrix (:func:`backward_plan` gives its padding, its split of dW's sum
and its scratch), keeps the pre-activation streams of every hidden layer,
and sums the partial gradients in a fixed order, in double (bit-for-bit
repeatable).

K6, the Taylor-2 pass under the bf16 stream policy of a mixed spec
(``ops.taylor._StreamPolicy``), is K1's kernel instantiated for the policy
(``csrc/taylor2.cu``); its backward is K2's instantiated likewise. It replaces
the TPU kernel ``mlp_taylor2_pallas_mixed`` (``_taylor2_kernel_mixed``;
``fused_mlp.py`` at git ``89afc4b^``: kernel line 285, wrapper 329,
``pallas_call`` 373) and its differentiable op ``make_taylor2_mixed_op``
(line 391), whose VJP JAX took by an XLA recompute. :func:`taylor2` and
:func:`taylor2_backward` launch K6 and its backward for a mixed spec, K1 and
K2 otherwise; the plain versions are the same functions as K1's and K2's,
on the same spec. K6 takes float32 masters and a bfloat16 compute dtype.

Fourier features (``spec.fourier``) and shock paths (``spec.n_paths``) ride
in K1's tiled design and in K2 (float32 only): the first layer's input is
[x^, t^, sin z, cos z, phi] with all four streams of each column, made in
the kernels' input passes (``csrc/fourier.cuh``); K2 also gives the paths'
gradient. A spec with either takes the tiled design at any width. K6 (the
mixed policy) refuses them (ROADMAP queue 2).

The float64 modes (``polish`` on the card): a float64 spec whose widths
are all at most NARROW_WIDTH, with no features and no stream policy, takes
K1's narrow design instantiated on double (:func:`launch_config` with
``torch.float64``) and K2's float64 design (``csrc/taylor2_backward.cu``,
namespace ``k2d``: a tile of points a block, the net's streams in shared
memory, per-block partials in double summed in block order;
:func:`f64_backward_plan`), under the same ``torch.autograd.Function``.
Any other float64 spec raises :func:`check_float64`'s refusal, which names
the later slice (ROADMAP queue 2).

The wrappers validate everything the kernels assume and raise otherwise;
they never fall back to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import (
    PATH_KEYS,
    MLPSpec,
    Params,
    embed_streams,
    fourier_frequencies,
    normalize_inputs,
    path_backward_reference,
)
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops import taylor
from pinns_tpu_torch.ops.taylor import POLICY_STREAMS, _StreamPolicy, taylor2_layer

LAUNCHES = 0  # K1 launches in this process (chip_smoke.py reads it)
MEMBER_LAUNCHES = 0  # K8s (a) launches: K1 over the members of an ensemble
BACKWARD_LAUNCHES = 0  # K2 calls in this process (one host call issues all its launches)
MIXED_LAUNCHES = 0  # K6 launches
MIXED_BACKWARD_LAUNCHES = 0  # K6 backward calls
F64_LAUNCHES = 0  # launches of K1's float64 mode (the narrow design in double)
F64_BACKWARD_LAUNCHES = 0  # calls of K2's float64 mode (its kernel + reduction)
_launches_lock = threading.Lock()  # HTTP handler threads launch concurrently

MAX_WIDTH = 256
MAX_PATHS = 8  # kMaxPaths, kMaxPathDegree, kMaxFourier in csrc/fourier.cuh
MAX_PATH_DEGREE = 7
MAX_FOURIER = 64  # B goes to the kernels by value
# The forward's two designs (csrc/taylor2.cu), one launch a call each. A net
# whose widths are all at most NARROW_WIDTH takes the narrow design, a
# per-tile kernel: a thread owns one unit and 4 points of all four streams,
# the tile is the largest multiple of 4 points (at most 128) whose two
# ping-pong buffers fit _NARROW_SMEM. Any wider net takes the tiled design:
# TILE_POINTS points a block, their 4 TILE_POINTS stacked stream rows (row =
# 4 point + stream) in shared memory k-major, a thread an 8 x 8 register
# tile (the four streams of two points by 8 units) of each layer's product,
# W_l fed in slices of SLICE_DEPTH rows through a ring of STAGES stages (and,
# under the bf16 policy, two slots of the bf16-rounded slices).
NARROW_WIDTH = 32
_POINTS_PER_THREAD = 4
_NARROW_SMEM = 112 * 1024  # two narrow blocks per H100 SM
_NARROW_MAX_TILE = 128
_NARROW_MAX_THREADS = 640  # the narrow kernel's __launch_bounds__
TILE_POINTS = 32
TILE_ROWS = 4 * TILE_POINTS
SLICE_DEPTH = 16
STAGES = 3
TILED_MAX_THREADS = 512  # the tiled kernel's __launch_bounds__
SMEM_LIMIT = 232_448  # the H100's 227 KB of shared memory a block
# the backward's products (csrc/taylor2_backward.cu::gemm_kernel): a block
# of GEMM_THREADS threads computes a GEMM_TILE x GEMM_TILE tile from three
# stages of 8-deep tiles of A and B with padded rows; the points are padded
# to a multiple of GEMM_TILE, so that a row tile lies in one stream, and the
# elementwise passes and db's per-tile sums walk tiles of GEMM_TILE points
GEMM_TILE = 128
GEMM_THREADS = 256
GEMM_SMEM = 4 * 3 * 2 * 8 * (GEMM_TILE + 4)
# the split of dW's sum over the stacked rows: enough chunks that the widest
# product keeps about SPLIT_WARPS warps busy (a warp computes a 32 x 64 piece
# of dW: 28 pieces at width 200, so 64 splits at 8,192 points), each chunk of
# at most MAX_SPLIT_TILES row tiles, so that no float32 chain runs longer than
# 1,024 rows
SPLIT_WARPS = 2048
MAX_SPLIT_TILES = 8


# K2's float64 design (csrc/taylor2_backward.cu, namespace k2d): points a
# tile, a block's threads, and the most blocks a call (two per SM of an H100)
F64_TILE = 32
F64_THREADS = 256
F64_MAX_GRID = 264
_F64_MAX_THREADS = 256  # K1's float64 mode's __launch_bounds__ (kMaxThreadsF64)
_F64_MAX_TILE = 64
FLOAT64_LATER = ("is left to a later slice (ROADMAP queue 2: float64 in K3, K7a, K7b, the "
                 "tiled K1, the wide K2 and K5, Fourier features and shock paths); the card "
                 "runs float64 on K10's float64 mode and the narrow designs of K1, K2 and K5 "
                 f"(every width <= {NARROW_WIDTH}, no features)")


def check_float64(kernel: str, spec: MLPSpec, mode: bool = True) -> None:
    """Raise NotImplementedError, naming the later slice, unless ``spec`` is
    float32 or the ``kernel`` has a float64 mode (``mode``) that takes it:
    the narrow design (every width at most NARROW_WIDTH, a first width of
    2), no Fourier or path features. (A stream policy takes float32
    masters: ``check_mixed`` refuses float64 ones first.)"""
    if spec.dtype != torch.float64:
        return
    why = []
    if not mode:
        why.append(f"the {kernel} kernel has no float64 mode")
    if spec.fourier or spec.n_paths:
        why.append("Fourier or shock-path features in float64")
    if max(spec.widths) > NARROW_WIDTH:
        why.append(f"widths {spec.widths} in float64 (the tiled / wide design)")
    if why:
        raise NotImplementedError(f"{kernel}: {'; '.join(why)} {FLOAT64_LATER}")


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """A forward launch: the design ("narrow" or "tiled"), points and threads
    a block, and its dynamic shared memory in bytes."""

    design: str
    tile: int
    threads: int
    smem: int


def launch_config(layers: Sequence[int], mixed: bool = False,
                  dtype: torch.dtype = torch.float32) -> LaunchConfig:
    """How K1, or K6 for a ``mixed`` spec, launches for a net of these widths
    (``spec.widths``: a first width above 2, Fourier or path features, takes
    the tiled design at any width; the kernel refuses any other
    configuration). ``dtype`` float64: K1's float64 mode, the narrow design
    on 8-byte values (at most _F64_MAX_TILE points and _F64_MAX_THREADS
    threads a block)."""
    layers = tuple(int(w) for w in layers)
    wmax = max(layers)
    if wmax > MAX_WIDTH:
        raise ValueError(f"taylor2 kernel takes widths up to {MAX_WIDTH}, got {wmax}")
    if dtype == torch.float64:
        if wmax > NARROW_WIDTH or layers[0] != 2 or mixed:
            raise NotImplementedError(f"taylor2: widths {layers} in float64 {FLOAT64_LATER}")
        tile = _NARROW_SMEM // (8 * 2 * 4 * wmax) - 4
        tile = min(_F64_MAX_TILE, tile - tile % _POINTS_PER_THREAD)
        items = (tile // _POINTS_PER_THREAD) * max(layers[1:])
        threads = min(_F64_MAX_THREADS, -(-items // 32) * 32)
        return LaunchConfig("narrow", tile, threads, 8 * 2 * 4 * wmax * (tile + 4))
    if wmax <= NARROW_WIDTH and layers[0] == 2:
        tile = _NARROW_SMEM // (4 * 2 * 4 * wmax) - 4  # bytes/(f32*bufs*streams*rows) - pad
        tile = min(_NARROW_MAX_TILE, tile - tile % _POINTS_PER_THREAD)
        items = (tile // _POINTS_PER_THREAD) * max(layers[1:])
        threads = min(_NARROW_MAX_THREADS, -(-items // 32) * 32)
        return LaunchConfig("narrow", tile, threads, 4 * 2 * 4 * wmax * (tile + 4))
    win = max(layers[:-1])  # the widest layer input
    groups = -(-win // 8)  # 8-unit column groups
    threads = max(TILE_ROWS, 16 * groups)
    pitch = 8 * groups
    smem = 4 * (win * TILE_ROWS + (STAGES + (2 if mixed else 0)) * SLICE_DEPTH * pitch)
    return LaunchConfig("tiled", TILE_POINTS, threads, smem)


def _ld_h(width: int) -> int:
    """The row pitch of a stacked input of this width: its columns, the
    bias's indicator, padded to 4 floats (``ld_h`` in the kernel)."""
    return (width + 4) // 4 * 4


def _align4(floats: int) -> int:
    return -(-floats // 4) * 4


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How K2 (K6's backward) lays out a call of n points: the points padded
    to ``n_pad`` (a multiple of GEMM_TILE, so a row tile of the 4 n_pad
    stacked stream rows lies in one stream), dW's sum over those rows cut
    into ``splits`` chunks of ``split_rows`` (the last one shorter), and the
    parts of its float32 scratch (in floats, each rounded up to 16 bytes, in
    the kernel's order): db's per-tile sums (doubles), the stacked input
    streams, the pre-activations of every hidden layer, the stacked inputs
    of one layer (each row holds the bias's indicator after the streams and
    is padded to 16 bytes), two adjoint buffers, the split partials, and the
    bf16-rounded weights of a mixed spec, and the path gradient's
    per-128-point partials (doubles) of a shock-path net. The kernel lays the
    scratch out itself and refuses a plan that does not fit it."""

    n_pad: int
    split_rows: int
    splits: int
    sums: int
    h0: int
    pstore: int
    hbuf: int
    gbuf: int
    partials: int
    wq: int
    psums: int = 0

    @property
    def scratch_floats(self) -> int:
        return (self.sums + self.h0 + self.pstore + self.hbuf + self.gbuf + self.partials
                + self.wq + self.psums)

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def backward_plan(layers: Sequence[int], n: int, mixed: bool = False,
                  path_params: int = 0) -> BackwardPlan:
    """K2's plan for ``n`` points through a net of these widths
    (``spec.widths``) with ``path_params`` path parameters
    (``spec.n_path_params``)."""
    layers = tuple(int(w) for w in layers)
    if max(layers) > MAX_WIDTH:
        raise ValueError(f"taylor2 backward kernel takes widths up to {MAX_WIDTH}, "
                         f"got {max(layers)}")
    n_pad = max(1, -(-n // GEMM_TILE)) * GEMM_TILE
    rows = 4 * n_pad
    tiles = rows // GEMM_TILE
    pieces = max(-(-din // 32) * -(-dout // 64) for din, dout in zip(layers[:-1], layers[1:]))
    per_split = min(MAX_SPLIT_TILES, -(-tiles // -(-SPLIT_WARPS // pieces)))
    splits = -(-tiles // per_split)
    n_params = sum(din * dout + dout for din, dout in zip(layers[:-1], layers[1:]))
    return BackwardPlan(
        n_pad=n_pad, split_rows=per_split * GEMM_TILE, splits=splits,
        sums=_align4(2 * (len(layers) - 1) * (n_pad // GEMM_TILE) * max(layers)),
        h0=rows * _ld_h(layers[0]), pstore=rows * sum(layers[1:-1]),
        hbuf=rows * _ld_h(max(layers)), gbuf=2 * rows * max(layers),
        partials=_align4(splits * n_params), wq=_align4(n_params) if mixed else 0,
        psums=_align4(2 * (n_pad // GEMM_TILE) * path_params))


@dataclasses.dataclass(frozen=True)
class F64BackwardPlan:
    """How K2's float64 mode lays out a call: ``grid`` blocks walk the tiles
    of F64_TILE points; per block a row of ``n_params`` partials and the
    pre-activation streams of every hidden layer of one tile (``pstore``
    doubles a block)."""

    grid: int
    n_params: int
    pstore: int


def f64_backward_plan(layers: Sequence[int], n: int) -> F64BackwardPlan:
    """K2's float64 plan for ``n`` >= 1 points through a narrow net of these
    widths."""
    layers = tuple(int(w) for w in layers)
    grid = max(1, min(F64_MAX_GRID, -(-n // F64_TILE)))
    n_params = sum(din * dout + dout for din, dout in zip(layers[:-1], layers[1:]))
    return F64BackwardPlan(grid=grid, n_params=n_params,
                           pstore=max(1, (len(layers) - 2) * 4 * max(layers) * F64_TILE))


def _lib():
    lib = build.load_library("taylor2")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        d = ctypes.c_double
        lib.pinns_taylor2_forward_f64.argtypes = [  # K1's float64 mode
            p, i, p, p, i, d, d, d, d, i, i, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_forward_f64.restype = i
        lib.pinns_taylor2_forward.argtypes = [  # + the features (feature_args)
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_forward.restype = i
        lib.pinns_taylor2_mixed_forward.argtypes = [  # K6: + the policy word
            p, i, p, p, i, i, f, f, f, f, i, i, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_mixed_forward.restype = i
        lib.pinns_taylor2_forward_members.argtypes = [  # K8s (a): + members, param stride
            p, i, p, i, ctypes.c_longlong, p, i, i, p, i, i, f, f, f, f, i, i, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_forward_members.restype = i
        lib.pinns_cuda_error_string.argtypes = [i]
        lib.pinns_cuda_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def _backward_lib():
    lib = build.load_library("taylor2_backward")
    if not getattr(lib, "_pinns_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        q = ctypes.c_longlong
        lib.pinns_taylor2_backward.argtypes = [  # + the features
            p, i, p, p, i, i, p, i, i, f, f, f, f, i, i, i, p, p, p, p, p, q, p, i, p,
        ]
        lib.pinns_taylor2_backward.restype = i
        lib.pinns_taylor2_mixed_backward.argtypes = [  # K6's: + the policy word
            p, i, p, p, i, i, f, f, f, f, i, i, i, p, p, p, p, p, q, p, i, p,
        ]
        lib.pinns_taylor2_mixed_backward.restype = i
        d = ctypes.c_double
        lib.pinns_taylor2_backward_f64.argtypes = [  # K2's float64 mode
            p, i, p, p, i, d, d, d, d, i, p, p, p, p, p, p, p, i, p,
        ]
        lib.pinns_taylor2_backward_f64.restype = i
        lib.pinns_taylor2_backward_error_string.argtypes = [i]
        lib.pinns_taylor2_backward_error_string.restype = ctypes.c_char_p
        lib._pinns_typed = True
    return lib


def net_leaves(params: Params) -> List[torch.Tensor]:
    """The net's tensors in kernel order: W_0, b_0, W_1, b_1, ..., then a
    shock-path net's ``path_c`` and ``path_a`` (on ``params[0]``)."""
    leaves = [t for layer in params for t in (layer["W"], layer["b"])]
    return leaves + [params[0][k] for k in PATH_KEYS if params and k in params[0]]


def net_from_leaves(leaves: Sequence[torch.Tensor], n_paths: int) -> Params:
    """The inverse of :func:`net_leaves` (``n_paths`` > 0: the last two
    leaves are the path parameters)."""
    trunk = leaves[:-2] if n_paths else leaves
    params = [{"W": w, "b": b} for w, b in zip(trunk[0::2], trunk[1::2])]
    if n_paths:
        params[0] = dict(params[0], path_c=leaves[-2], path_a=leaves[-1])
    return params


def pack_params(params: Params) -> torch.Tensor:
    """:func:`net_leaves` flattened into one buffer, in kernel order."""
    return torch.cat([t.reshape(-1) for t in net_leaves(params)])


def check_paths(kernel: str, spec: MLPSpec) -> None:
    """Raise unless the spec's Fourier and path features fit the bounds of
    the kernels that compute them (K1's tiled design, K2, K7a, K5's wide
    design; ``csrc/fourier.cuh``)."""
    if spec.n_paths > MAX_PATHS or spec.path_degree > MAX_PATH_DEGREE:
        raise ValueError(f"the {kernel} kernel takes up to {MAX_PATHS} paths of degree up to "
                         f"{MAX_PATH_DEGREE}, got {spec.n_paths} of degree {spec.path_degree}")
    if spec.n_fourier > MAX_FOURIER:
        raise ValueError(f"the {kernel} kernel takes up to {MAX_FOURIER} Fourier features "
                         f"(B goes to it by value), got {spec.n_fourier}")


@functools.lru_cache(maxsize=64)
def _frequencies(spec: MLPSpec) -> np.ndarray:
    return np.ascontiguousarray(fourier_frequencies(spec).reshape(-1), dtype=np.float32)


def feature_args(spec: MLPSpec) -> tuple:
    """(n_fourier, a host pointer to 2 pi B[:, 0] then 2 pi B[:, 1] as
    float32 or None, n_paths, path_degree) as the kernels' launchers take
    them. The frequencies are kept per spec, so the pointer outlives the
    call."""
    n_fourier, freqs = (spec.n_fourier, _frequencies(spec).ctypes.data) if spec.fourier \
        else (0, None)
    return n_fourier, freqs, spec.n_paths, spec.path_degree if spec.n_paths else 0


def refuse_features(kernel: str, spec: MLPSpec, why: str) -> None:
    """Raise unless ``spec`` has neither Fourier nor shock-path features:
    the kernels that compute none (K6, K3, K10's narrow scope, the narrow
    designs) name ``why`` (what takes such a spec instead)."""
    if spec.n_paths or spec.fourier:
        raise ValueError(
            f"the {kernel} kernel computes no Fourier or shock-path features "
            f"(model.n_fourier={spec.n_fourier}, model.n_paths={spec.n_paths}); {why}")


def split_grad(flat: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A flat gradient in ``pack_params`` order cut into tensors shaped like
    ``leaves`` (W_0, b_0, W_1, ...)."""
    return [g.view(t.shape) for g, t in zip(flat.split([t.numel() for t in leaves]), leaves)]


def check_call(kernel: str, spec: MLPSpec, params: Params, x: torch.Tensor,
               *per_point: torch.Tensor) -> None:
    """Raise ValueError unless ``x`` is contiguous (N, 2) in the spec's dtype
    on a CUDA device, ``params`` layers of ``spec``'s widths in that dtype
    on that device, and each of ``per_point`` a contiguous (N, out_dim)
    tensor of that dtype there. The spec's dtype is float32, or float64 for a
    kernel whose float64 mode :func:`check_float64` let through first. (The
    stream policy is each kernel's own check: K5 ignores it.)"""
    want_dtype = spec.dtype if spec.dtype == torch.float64 else torch.float32
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got device {x.device}")
    if x.dtype != want_dtype:
        raise ValueError(f"{kernel} kernel takes {want_dtype} points, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 2 or spec.in_dim != 2:
        raise ValueError(f"{kernel} kernel takes (N, 2) points, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} kernel needs contiguous points")
    layers = spec.widths
    if len(params) != len(layers) - 1:
        raise ValueError(f"{len(params)} layers of params for widths {layers}")
    for i, (layer, din, dout) in enumerate(zip(params, layers[:-1], layers[1:])):
        shapes = [("W", (din, dout)), ("b", (1, dout))]
        if i == 0 and spec.n_paths:
            shapes += [("path_c", (spec.n_paths, spec.path_degree + 1)),
                       ("path_a", (spec.n_paths,))]
        for name, shape in shapes:
            t = layer[name]
            if tuple(t.shape) != shape or t.dtype != want_dtype or t.device != x.device:
                raise ValueError(
                    f"layer {i} {name}: want {want_dtype} {shape} on {x.device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
    want = (x.shape[0], spec.out_dim)
    for t in per_point:
        if tuple(t.shape) != want or t.dtype != want_dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: per-point tensors (cotangents, outputs) must "
                             f"be contiguous {want_dtype} {want} "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


MIXED_FEATURES = ("the mixed stream policy with Fourier or path features is left to a later "
                  "slice (ROADMAP queue 2, K6); a float32 spec takes K1 and K2")


def policy_flags(spec: MLPSpec) -> int:
    """K6's policy word: 1 value quantized, 2 x/t derivatives quantized, 4 xx
    quantized, 8 mixed_elementwise (the derivatives are always quantized:
    ``keep_streams`` names only 'value' and 'xx')."""
    keep = set(spec.keep_streams)
    return ((0 if "value" in keep else 1) | 2 | (0 if "xx" in keep else 4)
            | (8 if spec.mixed_elementwise else 0))


def check_mixed(kernel: str, spec: MLPSpec) -> None:
    """Raise ValueError unless K6 takes the mixed ``spec``: bfloat16 streams
    on float32 masters, widths up to MAX_WIDTH."""
    if spec.dtype != torch.float32:
        raise ValueError(f"{kernel} kernel takes float32 masters, got {spec.dtype}")
    if spec.compute_dtype != torch.bfloat16:
        raise ValueError(f"{kernel} kernel computes in bfloat16, got {spec.compute_dtype}")
    if max(spec.layers) > MAX_WIDTH:
        raise ValueError(f"{kernel} kernel takes widths up to {MAX_WIDTH}, "
                         f"got {max(spec.layers)}")


def taylor2(
    spec: MLPSpec, params: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, u_x, u_t, u_xx), each (N, out_dim) float32, from one launch of K1,
    or of K6 under a mixed spec's stream policy; in float64 from one launch
    of K1's float64 mode for a float64 spec it takes (:func:`check_float64`).

    ``x`` is the (N, 2) raw points in the spec's dtype, contiguous on a CUDA
    device; ``params`` the JAX-layout layers on the same device. Raises on
    anything else.
    """
    global LAUNCHES, MIXED_LAUNCHES
    kernel = "taylor2_mixed" if spec.mixed else "taylor2"
    if spec.mixed:
        refuse_features(kernel, spec, MIXED_FEATURES)
        check_mixed(kernel, spec)
    check_float64(kernel, spec)
    if spec.dtype == torch.float64:
        return _taylor2_f64(spec, params, x)
    check_paths(kernel, spec)
    check_call(kernel, spec, params, x)
    layers = spec.widths
    cfg = launch_config(layers, spec.mixed)
    flat = pack_params(params)
    n = x.shape[0]
    outs = tuple(
        torch.empty((n, spec.out_dim), dtype=torch.float32, device=x.device)
        for _ in range(4)
    )
    if n == 0:
        return outs
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1)
    tail = (spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], cfg.tile, cfg.threads,
            *(o.data_ptr() for o in outs), x.device.index or 0, stream)
    if spec.mixed:
        err = lib.pinns_taylor2_mixed_forward(*head, policy_flags(spec), *tail)
    else:
        err = lib.pinns_taylor2_forward(*head, *feature_args(spec), *tail)
    if err != 0:
        msg = lib.pinns_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} ({msg}); "
            f"{cfg}"
        )
    with _launches_lock:
        if spec.mixed:
            MIXED_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return outs


def _taylor2_f64(spec: MLPSpec, params: Params, x: torch.Tensor):
    """K1's float64 mode: one launch of the narrow design on double."""
    global F64_LAUNCHES
    check_call("taylor2 float64", spec, params, x)
    layers = spec.widths
    cfg = launch_config(layers, dtype=torch.float64)
    flat = pack_params(params)
    n = x.shape[0]
    outs = tuple(torch.empty((n, spec.out_dim), dtype=torch.float64, device=x.device)
                 for _ in range(4))
    if n == 0:
        return outs
    lib = _lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    err = lib.pinns_taylor2_forward_f64(
        x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, spec.lb[0], spec.lb[1],
        spec.ub[0], spec.ub[1], cfg.tile, cfg.threads, *(o.data_ptr() for o in outs),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.pinns_cuda_error_string(err).decode()
        raise RuntimeError(f"taylor2 float64 kernel launch failed: CUDA error {err} ({msg}); "
                           f"{cfg}")
    with _launches_lock:
        F64_LAUNCHES += 1
    return outs


def _taylor2_backward_f64(spec: MLPSpec, params: Params, x: torch.Tensor,
                          cotangents: Sequence[torch.Tensor]) -> torch.Tensor:
    """K2's float64 mode: the per-tile kernel and the block-order reduction,
    from one host call."""
    global F64_BACKWARD_LAUNCHES
    check_call("taylor2 float64 backward", spec, params, x, *cotangents)
    layers = spec.widths
    n = x.shape[0]
    grad = torch.empty(spec.n_params, dtype=torch.float64, device=x.device)
    if n == 0:
        return grad.zero_()
    plan = f64_backward_plan(layers, n)
    partials = torch.empty((plan.grid, plan.n_params), dtype=torch.float64, device=x.device)
    pstore = torch.empty(plan.grid * plan.pstore, dtype=torch.float64, device=x.device)
    lib = _backward_lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    err = lib.pinns_taylor2_backward_f64(
        x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1, spec.lb[0], spec.lb[1],
        spec.ub[0], spec.ub[1], plan.grid, *(g.data_ptr() for g in cotangents),
        partials.data_ptr(), pstore.data_ptr(), grad.data_ptr(), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.pinns_taylor2_backward_error_string(err).decode()
        raise RuntimeError(f"taylor2 float64 backward kernel launch failed: CUDA error {err} "
                           f"({msg}); {plan}")
    with _launches_lock:
        F64_BACKWARD_LAUNCHES += 1
    return grad


def nets_from_flat(spec: MLPSpec, flat: torch.Tensor) -> List[Params]:
    """The member nets of an (E, S) buffer (S >= ``spec.n_params``) whose row
    m holds member m's :func:`pack_params`, as views of its rows."""
    shapes = [s for din, dout in zip(spec.widths[:-1], spec.widths[1:])
              for s in ((din, dout), (1, dout))]
    if spec.n_paths:
        shapes += [(spec.n_paths, spec.path_degree + 1), (spec.n_paths,)]
    nets = []
    for row in flat:
        leaves, off = [], 0
        for shape in shapes:
            size = int(torch.Size(shape).numel())
            leaves.append(row[off:off + size].view(shape))
            off += size
        nets.append(net_from_leaves(leaves, spec.n_paths))
    return nets


def taylor2_members(spec: MLPSpec, flat: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8s (a): (u, u_x, u_t, u_xx), each (E, N, out_dim) float32, of the E
    member nets in ``flat`` (E, S) float32 contiguous on ``x``'s CUDA device,
    row m member m's :func:`pack_params` (S >= ``spec.n_params``; an S that is
    a multiple of 4 keeps the tiled design's 16-byte weight copies), from one
    launch of K1 with the member as the grid's y. Member m's streams equal a
    solo :func:`taylor2` call on its net bit for bit (Fourier and path
    features included: a member's paths follow its trunk in its row).
    Float32 specs only; raises on anything else."""
    global MEMBER_LAUNCHES
    kernel = "taylor2 members"
    check_float64(kernel, spec, mode=False)
    check_paths(kernel, spec)
    if spec.mixed:
        raise ValueError(f"the {kernel} kernel takes float32 specs; the member axis of K6 "
                         "(a mixed stream policy) is later work (ROADMAP queue 2)")
    if flat.ndim != 2 or flat.dtype != torch.float32 or flat.device != x.device \
            or not flat.is_contiguous() or flat.shape[1] < spec.n_params:
        raise ValueError(f"{kernel}: want a contiguous float32 (E, >= {spec.n_params}) buffer "
                         f"on {x.device}, got {flat.dtype} {tuple(flat.shape)} on {flat.device}")
    check_call(kernel, spec, nets_from_flat(spec, flat[:1])[0], x)
    e, n = flat.shape[0], x.shape[0]
    if not 1 <= e <= 65535:
        raise ValueError(f"{kernel}: 1 to 65,535 members, got {e}")
    cfg = launch_config(spec.widths)
    outs = tuple(torch.empty((e, n, spec.out_dim), dtype=torch.float32, device=x.device)
                 for _ in range(4))
    if n == 0:
        return outs
    lib = _lib()
    layers = spec.widths
    dims = (ctypes.c_int * len(layers))(*layers)
    err = lib.pinns_taylor2_forward_members(
        x.data_ptr(), n, flat.data_ptr(), e, flat.shape[1], dims, len(layers) - 1,
        *feature_args(spec), spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], cfg.tile, cfg.threads,
        *(o.data_ptr() for o in outs), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.pinns_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg}); {cfg}, "
                           f"{e} members")
    with _launches_lock:
        MEMBER_LAUNCHES += 1
    return outs


def taylor2_members_reference(spec: MLPSpec, flat: torch.Tensor, x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`taylor2_members`: the plain recurrence
    (``ops.taylor.mlp_taylor_2_reference``) member by member, stacked."""
    per = [taylor.mlp_taylor_2_reference(spec, net, x) for net in nets_from_flat(spec, flat)]
    return tuple(torch.stack([p[s] for p in per]) for s in range(4))


def taylor2_backward(spec: MLPSpec, params: Params, x: torch.Tensor,
                     cotangents: Sequence[torch.Tensor]) -> torch.Tensor:
    """K2, or K6's backward under a mixed spec (casts taken as identity), or
    K2's float64 mode for a float64 spec (:func:`check_float64`): the
    flat gradient (``pack_params`` order) of sum over points of
    gu . u + gux . u_x + gut . u_t + guxx . u_xx, where ``cotangents`` =
    (gu, gux, gut, guxx), each (N, out_dim) in the spec's dtype, contiguous,
    on ``x``'s CUDA device. One host call that issues every product, elementwise pass
    and the reduction (``backward_plan``); a shock-path net's gradient ends
    with its paths' (``pack_params`` order). Raises on anything the kernel
    does not take."""
    global BACKWARD_LAUNCHES, MIXED_BACKWARD_LAUNCHES
    kernel = "taylor2_mixed backward" if spec.mixed else "taylor2 backward"
    if len(cotangents) != 4:
        raise ValueError(f"{kernel} takes 4 stream cotangents, got {len(cotangents)}")
    if spec.mixed:
        refuse_features(kernel, spec, MIXED_FEATURES)
        check_mixed(kernel, spec)
    check_float64(kernel, spec)
    if spec.dtype == torch.float64:
        return _taylor2_backward_f64(spec, params, x, cotangents)
    check_paths(kernel, spec)
    check_call(kernel, spec, params, x, *cotangents)
    layers = spec.widths
    n = x.shape[0]
    grad = torch.empty(spec.n_params, dtype=torch.float32, device=x.device)
    if n == 0:
        return grad.zero_()
    plan = backward_plan(layers, n, spec.mixed, spec.n_path_params)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
    lib = _backward_lib()
    dims = (ctypes.c_int * len(layers))(*layers)
    flat = pack_params(params)
    head = (x.data_ptr(), n, flat.data_ptr(), dims, len(layers) - 1)
    tail = (spec.lb[0], spec.lb[1], spec.ub[0], spec.ub[1], plan.n_pad, plan.split_rows,
            plan.splits, *(g.data_ptr() for g in cotangents), scratch.data_ptr(),
            plan.scratch_floats, grad.data_ptr(), x.device.index or 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if spec.mixed:
        err = lib.pinns_taylor2_mixed_backward(*head, policy_flags(spec), *tail)
    else:
        err = lib.pinns_taylor2_backward(*head, *feature_args(spec), *tail)
    if err != 0:
        msg = lib.pinns_taylor2_backward_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg}); {plan}")
    with _launches_lock:
        if spec.mixed:
            MIXED_BACKWARD_LAUNCHES += 1
        else:
            BACKWARD_LAUNCHES += 1
    return grad


class _Taylor2(torch.autograd.Function):
    """K1 (K6) forward, K2 (K6's backward) as its VJP (w.r.t. the params
    only). Saves only (x, params): the backward recomputes the forward, so a
    caller needs no checkpoint around it."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        return taylor2(spec, net_from_leaves(leaves, spec.n_paths), x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        x, *leaves = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the taylor2 kernels give no gradient with respect "
                                      "to the input points")
        params = net_from_leaves(leaves, ctx.spec.n_paths)
        grad = taylor2_backward(ctx.spec, params, x, [g.contiguous() for g in cotangents])
        return (None, None, *split_grad(grad, leaves))


def mlp_taylor2_kernel(spec: MLPSpec, params: Params, x: torch.Tensor):
    """(u, u_x, u_t, u_xx) through K1 (K6 for a mixed spec), differentiable
    in the params through K2 (K6's backward), Fourier and shock-path
    features included (float32); a narrow float64 spec through K1's and
    K2's float64 modes. CUDA tensors only (the wrappers raise on anything
    else)."""
    return _Taylor2.apply(spec, x, *net_leaves(params))


# -- the plain version of K2 and of K6's backward: the hand-written reverse mode

def _act_backward(pre, tanh, gH):
    """Adjoints of a tanh layer's pre-activation streams from those of its
    output streams (the formulas in the header of csrc/taylor2_backward.cu),
    at the forward's pre-activations ``pre`` = (p, px, pt, pxx) and tanh
    factors ``tanh`` = (s, s', s''). Casts are taken as identity."""
    p, px, pt, pxx = pre
    s, d1, d2 = tanh
    gh, ghx, ght, ghxx = gH
    gpxx = ghxx * d1
    gpx = ghx * d1 + 2.0 * ghxx * d2 * px
    gpt = ght * d1
    gp = d1 * (gh - 2.0 * s * (ghx * px + ght * pt + ghxx * pxx)
               + (6.0 * s * s - 2.0) * ghxx * px * px)
    return gp, gpx, gpt, gpxx


def taylor2_backward_reference(spec: MLPSpec, net: Params, x: torch.Tensor,
                               cotangents) -> List[torch.Tensor]:
    """K2's algorithm (K6's backward for a mixed spec) in plain PyTorch:
    [dW_0, db_0, dW_1, ...] (W leaves (din, dout), b leaves (1, dout)), then
    d path_c and d path_a for a shock-path net (:func:`net_leaves` order), of
    sum over points of the cotangents (gu, gux, gut, guxx), each (N,
    out_dim), dotted with (u, u_x, u_t, u_xx). The paths' gradient applies
    ``models.mlp.path_backward_reference`` to the path columns of layer 0's
    input adjoints G_0 W_0^T, one per stream.

    Under a mixed policy the forward is recomputed with its rounding
    (``ops.taylor.taylor2_layer``), each stream's input adjoint takes the
    weights its forward dot used, and the casts count as identity: the
    cotangents stay in ``spec.dtype``, where autograd through the plain
    recurrence would round those of bf16 tensors to bf16."""
    pol = _StreamPolicy(spec)
    dtype = spec.dtype
    h = normalize_inputs(spec, x)
    n = x.shape[0]
    streams = embed_streams(spec, h, net[0])
    if streams[3] is None:  # the affine embedding: constant tangents, zero curvature
        streams = (h, streams[1].expand(n, -1), streams[2].expand(n, -1), torch.zeros_like(h))
    saved = []  # (pre-activation streams, tanh factors) of each hidden layer
    inputs = [streams]
    for i, layer in enumerate(net[:-1]):
        pre, tanh, streams = taylor2_layer(pol, streams, layer["W"], layer["b"], i == 0)
        saved.append((tuple(t.to(dtype) for t in pre), tuple(t.to(dtype) for t in tanh)))
        inputs.append(tuple(t.to(dtype) for t in streams))
    grads: List[Optional[torch.Tensor]] = [None] * (2 * len(net))
    G = tuple(g.reshape(x.shape[0], -1) for g in cotangents)
    for l in range(len(net) - 1, -1, -1):
        X = inputs[l]
        grads[2 * l] = sum(X[s].T @ G[s] for s in range(4))
        grads[2 * l + 1] = G[0].sum(dim=0, keepdim=True)
        if l > 0:
            w = net[l]["W"]
            gH = tuple(g @ pol.weight(w, stream).T for g, stream in zip(G, POLICY_STREAMS))
            G = _act_backward(*saved[l - 1], gH)
    if spec.n_paths:
        w_paths = net[0]["W"][2 + 2 * spec.n_fourier:]  # the path features' rows of W_0
        grads += list(path_backward_reference(spec, net[0], h, *(g @ w_paths.T for g in G)))
    return grads
