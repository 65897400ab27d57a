"""Port parity: pinns_tpu_torch.ops.taylor (and its CUDA kernel's wrapper)
against pinns_tpu.ops.taylor.mlp_taylor_2, and the tiled forward design of
K1 / K6 (csrc/taylor2.cu) written out in PyTorch (:func:`tiled_twin`)
against the plain recurrence and JAX's.

Tolerances: the twin against ``mlp_taylor_2_reference`` in float64 to 1e-12
of max|reference| per stream (the same products summed in other orders); in
float32 the per-stream TOL of torch_port_util against both the plain version
and JAX; under the bf16 policy (tests/test_torch_mixed.py) the card's
K6_PLAIN_TOL, 3e-5 max|plain| per stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.taylor import mlp_taylor_2 as jax_taylor_2
from pinns_tpu_torch.interop import load_params_npz, params_from_jax
from pinns_tpu_torch.models.mlp import MLPSpec, input_scale, normalize_inputs
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import (POLICY_STREAMS, _StreamPolicy, mlp_taylor_2,
                                        mlp_taylor_2_reference)
from torch_port_util import (
    FIXTURE,
    LB,
    SMALL,
    UB,
    assert_close,
    numpy_params,
    numpy_points,
)

CPU = torch.device("cpu")
STREAMS = ("u", "u_x", "u_t", "u_xx")


def _fixture_net():
    loaded = load_params_npz(FIXTURE)
    return loaded["spec"], loaded["params"]


def _small_net():
    return MLPSpec(layers=SMALL, lb=LB, ub=UB), numpy_params(SMALL, seed=10)


@pytest.mark.parametrize("net", [_small_net, _fixture_net], ids=["16x3", "20x8-trained"])
def test_mlp_taylor_2_matches_jax(net):
    spec, jparams = net()
    x = numpy_points(333, seed=11)
    got = mlp_taylor_2(spec, params_from_jax(jparams, CPU), torch.from_numpy(x))
    jspec = JSpec(layers=spec.layers, lb=spec.lb, ub=spec.ub)
    want = jax_taylor_2(
        jspec, [{k: jnp.asarray(v) for k, v in p.items()} for p in jparams], jnp.asarray(x)
    )
    for name, g, w in zip(STREAMS, got, want):
        assert g.shape == (333, 1) and g.dtype == torch.float32
        assert_close(name, g.numpy(), np.asarray(w))


def test_cpu_tensor_never_launches():
    spec, jparams = _small_net()
    before = k_taylor2.LAUNCHES
    mlp_taylor_2(spec, params_from_jax(jparams, CPU), torch.from_numpy(numpy_points(5, 0)))
    assert k_taylor2.LAUNCHES == before


@pytest.mark.parametrize(
    "extra", [{"compute_dtype": torch.bfloat16}, {"keep_streams": ("xx",)}],
    ids=["compute_dtype", "keep_streams"],
)
def test_mixed_stream_policy_raises(extra):
    """The policy computes on the CPU (keep_streams without compute_dtype is
    plain float32, as in JAX); the kernel wrapper, K6 for a mixed spec and K1
    otherwise, raises on a CPU tensor instead of falling back."""
    spec = MLPSpec(layers=SMALL, lb=LB, ub=UB, **extra)
    params = params_from_jax(numpy_params(SMALL, seed=0), CPU)
    x = torch.from_numpy(numpy_points(7, seed=1))
    got = mlp_taylor_2(spec, params, x)
    assert all(bool(torch.isfinite(t).all()) and t.dtype == torch.float32 for t in got)
    before = (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES)
    if not spec.mixed:
        plain = mlp_taylor_2(MLPSpec(layers=SMALL, lb=LB, ub=UB), params, x)
        assert all(torch.equal(g, w) for g, w in zip(got, plain))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_taylor2.taylor2(spec, params, x)
    assert (k_taylor2.LAUNCHES, k_taylor2.MIXED_LAUNCHES) == before


@pytest.mark.parametrize("width", [1, 20, 64, 200, 256])
def test_launch_config_fits_the_card(width):
    """Both designs within the H100's 227 KB of shared memory a block and
    their kernels' __launch_bounds__; the narrow design at widths <= 32; the
    tiled design's 16 row groups of 8 stacked rows cover its 4 x 32 rows, its
    column groups whole 8-unit register tiles of every layer, and the head's
    partial sums (a column group's by row) fit the ring."""
    layers = (2,) + (width,) * 8 + (1,)
    for mixed in (False, True):
        cfg = k_taylor2.launch_config(layers, mixed)
        assert cfg.smem <= k_taylor2.SMEM_LIMIT
        if width <= k_taylor2.NARROW_WIDTH:
            assert cfg.design == "narrow"
            assert cfg.tile >= 4 and cfg.tile % 4 == 0
            assert 32 <= cfg.threads <= 640 and cfg.threads % 32 == 0
            # two ping-pong buffers of four streams in half an SM's shared memory
            assert cfg.smem == 4 * 2 * 4 * max(layers) * (cfg.tile + 4) <= 112 * 1024
            continue
        rows, groups = k_taylor2.TILE_ROWS, -(-width // 8)
        ring = k_taylor2.STAGES * k_taylor2.SLICE_DEPTH
        assert cfg.design == "tiled" and cfg.tile == k_taylor2.TILE_POINTS
        assert rows == 4 * cfg.tile == 16 * 8  # 16 row groups of 2 points x 4 streams
        assert cfg.threads == max(rows, 16 * groups) <= k_taylor2.TILED_MAX_THREADS
        assert 8 * groups >= width and 8 * (groups - 1) < width  # whole tiles, none idle
        slots = ring + (2 * k_taylor2.SLICE_DEPTH if mixed else 0)
        assert cfg.smem == 4 * (width * rows + slots * 8 * groups)
        assert groups * rows <= ring * 8 * groups


def test_launch_config_rejects_wide_nets():
    with pytest.raises(ValueError, match="256"):
        k_taylor2.launch_config((2, 300, 1))


# -- the tiled design, written out --------------------------------------------

def tiled_twin(spec: MLPSpec, params, x: torch.Tensor):
    """(u, u_x, u_t, u_xx) as the tiled design of csrc/taylor2.cu computes
    them, for a float32 / float64 spec (K1) or a mixed one (K6).

    The points are cut into tiles of TILE_POINTS (the last padded with the
    point (0, 0)); a tile's four streams are TILE_ROWS stacked rows, row =
    4 point + stream, held k-major: S (din, rows). Layer l multiplies S by
    W_l in slices of SLICE_DEPTH rows of W, in order; a row of stream s takes
    the weights of its stream's dot (bf16(W) where the policy quantizes it,
    after layer 0). The epilogue takes p, px, pt, pxx of a (point, unit) from
    the rows 4 point .. 4 point + 3 and applies the tanh rule under the policy;
    its outputs are the next S. The head sums each 8-unit column group's
    products, then the groups in order, then adds b on value rows."""
    pol = _StreamPolicy(spec)
    dtype = spec.dtype
    tp, rows, kd = k_taylor2.TILE_POINTS, k_taylor2.TILE_ROWS, k_taylor2.SLICE_DEPTH
    n = x.shape[0]
    tiles = -(-n // tp)
    xp = torch.zeros((tiles * tp, 2), dtype=dtype)
    xp[:n] = x
    h = normalize_inputs(spec, xp).reshape(tiles, tp, 2)
    scale = input_scale(spec, xp.device)
    S = torch.zeros((tiles, 2, tp, 4), dtype=dtype)  # (tile, k, point, stream)
    S[..., 0] = h.transpose(1, 2)
    S[:, 0, :, 1] = scale[0]
    S[:, 1, :, 2] = scale[1]
    S = S.reshape(tiles, 2, rows)

    def product(S, W, first, k_range):
        """The stacked product over the rows k_range of W: each stream's rows
        (s::4) by the weights of that stream's dot."""
        out = torch.zeros((tiles, rows, W.shape[1]), dtype=dtype)
        for s, name in enumerate(POLICY_STREAMS):
            w = W if first else pol.weight(W, name)
            out[:, s::4] = S[:, k_range, s::4].transpose(1, 2) @ w[k_range]
        return out

    for i, layer in enumerate(params[:-1]):
        first = i == 0
        W, b = layer["W"], layer["b"]
        acc = torch.zeros((tiles, rows, W.shape[1]), dtype=dtype)
        for k0 in range(0, W.shape[0], kd):
            acc = acc + product(S, W, first, slice(k0, k0 + kd))
        p, px, pt, pxx = (acc[:, s::4] for s in range(4))  # (tile, point, unit)
        p = pol.act(p + b, "value", first)
        px, pt = pol.act(px, "deriv", first), pol.act(pt, "deriv", first)
        pxx = pol.act(pxx, "xx", first)
        s = torch.tanh(p)
        sp = 1.0 - s * s
        spp = -2.0 * s * sp
        outs = (pol.store(s, "value"), pol.store(sp * px, "deriv"), pol.store(sp * pt, "deriv"),
                pol.store(spp * px * px + sp * pxx, "xx"))
        S = torch.stack([o.to(dtype) for o in outs], dim=-1)  # (tile, point, unit, stream)
        S = S.permute(0, 2, 1, 3).reshape(tiles, -1, rows)
    W, b = params[-1]["W"], params[-1]["b"]
    first = len(params) == 1
    total = None
    for c0 in range(0, W.shape[0], 8):
        part = product(S, W, first, slice(c0, c0 + 8))
        total = part if total is None else total + part
    total[:, 0::4] += b
    total = total.reshape(tiles * tp, 4, W.shape[1])[:n]
    return tuple(total[:, s] for s in range(4))


TWIN_NETS = {"3x24": (2, 24, 24, 24, 1), "4x40": (2, 40, 40, 40, 40, 1)}
TWIN_NS = (1, 31, 33)


def twin_case(net, n, seed, dtype=torch.float32, **policy):
    layers = TWIN_NETS[net]
    spec = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=dtype, **policy)
    jparams = numpy_params(layers, seed)
    params = [{k: torch.tensor(v, dtype=dtype) for k, v in p.items()} for p in jparams]
    x = numpy_points(n, seed + 1)
    return spec, jparams, params, x


@pytest.mark.parametrize("n", TWIN_NS)
@pytest.mark.parametrize("net", sorted(TWIN_NETS))
def test_tiled_twin_matches_reference_f64(net, n):
    spec, _, params, x = twin_case(net, n, seed=40, dtype=torch.float64)
    got = tiled_twin(spec, params, torch.tensor(x, dtype=torch.float64))
    want = mlp_taylor_2_reference(spec, params, torch.tensor(x, dtype=torch.float64))
    for name, g, w in zip(STREAMS, got, want):
        assert g.shape == w.shape == (n, 1)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("n", TWIN_NS)
@pytest.mark.parametrize("net", sorted(TWIN_NETS))
def test_tiled_twin_matches_jax_f32(net, n):
    spec, jparams, params, x = twin_case(net, n, seed=41)
    got = tiled_twin(spec, params, torch.from_numpy(x))
    plain = mlp_taylor_2_reference(spec, params, torch.from_numpy(x))
    want = jax_taylor_2(JSpec(layers=spec.layers, lb=spec.lb, ub=spec.ub),
                        [{k: jnp.asarray(v) for k, v in p.items()} for p in jparams],
                        jnp.asarray(x))
    for name, g, p, w in zip(STREAMS, got, plain, want):
        assert g.dtype == torch.float32 and g.shape == (n, 1)
        assert_close(name, g.numpy(), p.numpy())
        assert_close(name, g.numpy(), np.asarray(w))
