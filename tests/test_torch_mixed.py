"""Port parity for the bf16 stream policy (``ops/taylor.py::_StreamPolicy``):
the plain mixed Taylor-2 recurrence and its gradient against the JAX
package's ``mlp_taylor_2`` on the CPU, K6's backward algorithm in plain
PyTorch against autograd, the K6 wrapper's refusals, and the spec mapping of
a JAX ``burgers_scale`` run with a policy.

Net (2, 64, 64, 64, 1), 400 points, params and points from numpy seeds.
Tolerances: each stream (each gradient leaf) within relative L2 1e-3 of JAX's
(rounding to bf16 at the same points; measured <= 4.2e-4), and the port's
quantization error against the float32 pass at most 1.1 x JAX's + 1e-6 (the
two frameworks' errors agree to about three digits).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.ops.taylor import mlp_taylor_2 as jax_taylor_2
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import mlp_taylor_2, mlp_taylor_2_reference
from test_torch_taylor import TWIN_NETS, TWIN_NS, tiled_twin, twin_case
from torch_port_util import LB, UB, numpy_params, numpy_points

LAYERS = (2, 64, 64, 64, 1)
N = 400
LAM2 = 0.01 / math.pi
# (keep_streams, mixed_elementwise): every policy the JAX package names
POLICIES = [((), False), (("xx",), False), (("value",), False), (("value", "xx"), False),
            ((), True), (("xx",), True)]
POLICY_IDS = ["keep-none", "keep-xx", "keep-value", "keep-value-xx", "max", "max-keep-xx"]


def _specs(keep, mixed_elementwise):
    kw = dict(compute_dtype="bfloat16", keep_streams=keep, mixed_elementwise=mixed_elementwise)
    return (JSpec(layers=LAYERS, lb=LB, ub=UB, **kw), MLPSpec(layers=LAYERS, lb=LB, ub=UB, **kw))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_net(net):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in net]


def _torch_net(net, dtype=torch.float32, grad=False):
    return [{k: torch.tensor(v, dtype=dtype, requires_grad=grad) for k, v in layer.items()}
            for layer in net]


def _leaves(net):
    return [layer[k] for layer in net for k in ("W", "b")]


@pytest.mark.parametrize("keep,me", POLICIES, ids=POLICY_IDS)
def test_policy_streams_match_jax(keep, me):
    net, x = numpy_params(LAYERS, 20), numpy_points(N, 21)
    jspec, tspec = _specs(keep, me)
    want = jax_taylor_2(jspec, _jax_net(net), jnp.asarray(x))
    f32 = jax_taylor_2(JSpec(layers=LAYERS, lb=LB, ub=UB), _jax_net(net), jnp.asarray(x))
    got = mlp_taylor_2(tspec, _torch_net(net), torch.from_numpy(x))
    for name, g, w, e in zip(("u", "u_x", "u_t", "u_xx"), got, want, f32):
        assert g.dtype == torch.float32 and g.shape == (N, 1)
        assert _rel(g, w) <= 1e-3, name
        assert _rel(g, e) <= 1.1 * _rel(w, e) + 1e-6, name


def _residual_loss(u, ux, ut, uxx):
    r = ut + u * ux - LAM2 * uxx
    return (r * r).mean()


@pytest.mark.parametrize("keep,me", POLICIES, ids=POLICY_IDS)
def test_policy_gradient_matches_jax(keep, me):
    """The gradient of a mean-square Burgers residual through the policy:
    autograd through the port's plain version against jax.grad."""
    net, x = numpy_params(LAYERS, 22), numpy_points(N, 23)
    jspec, tspec = _specs(keep, me)

    def jgrad(spec):
        g = jax.grad(lambda p: _residual_loss(*jax_taylor_2(spec, p, jnp.asarray(x))))(
            _jax_net(net))
        return [np.asarray(t, np.float64) for t in _leaves(g)]

    want, f32 = jgrad(jspec), jgrad(JSpec(layers=LAYERS, lb=LB, ub=UB))
    tnet = _torch_net(net, grad=True)
    got = torch.autograd.grad(_residual_loss(*mlp_taylor_2(tspec, tnet, torch.from_numpy(x))),
                              _leaves(tnet))
    got = [g.double().numpy() for g in got]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= 1e-3, f"leaf {i}"
    flat = lambda gs: np.concatenate([g.ravel() for g in gs])  # noqa: E731
    assert _rel(flat(got), flat(f32)) <= 1.1 * _rel(flat(want), flat(f32)) + 1e-6


@pytest.mark.parametrize("keep,me", POLICIES, ids=POLICY_IDS)
def test_k6_backward_reference_matches_autograd(keep, me):
    """K6's backward algorithm (casts as identity, float32 cotangents) in
    plain PyTorch, as the card holds the kernel: per leaf, its error against
    the float64 gradient at most 2x that of autograd through the plain mixed
    version + 1e-6 of the leaf, and within max-relative 0.2 of autograd."""
    net, x = numpy_params(LAYERS, 24), numpy_points(N, 25)
    _, tspec = _specs(keep, me)
    rng = np.random.default_rng(26)
    cot = [torch.from_numpy((rng.standard_normal((N, 1)) / N).astype(np.float32))
           for _ in range(4)]
    got = k_taylor2.taylor2_backward_reference(tspec, _torch_net(net), torch.from_numpy(x), cot)
    tnet = _torch_net(net, grad=True)
    outs = mlp_taylor_2_reference(tspec, tnet, torch.from_numpy(x))
    auto = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)), _leaves(tnet))
    spec64 = MLPSpec(layers=LAYERS, lb=LB, ub=UB, dtype=torch.float64)
    exact = k_taylor2.taylor2_backward_reference(
        spec64, _torch_net(net, torch.float64), torch.from_numpy(x).double(),
        [c.double() for c in cot])
    for i, (g, a, e) in enumerate(zip(got, auto, exact)):
        g, a, e = g.double(), a.double(), e
        err, auto_err = float((g - e).abs().max()), float((a - e).abs().max())
        assert err <= 2.0 * auto_err + 1e-6 * float(e.abs().max()), (i, err, auto_err)
        assert float((g - a).abs().max()) <= 0.2 * float(a.abs().max()), i


# the policies of burgers_scale's cells (experiments/presets.py::STREAM_POLICIES)
TWIN_POLICIES = {"keep-none": ((), False), "keep-xx": (("xx",), False), "max": ((), True)}
K6_PLAIN_TOL = 3e-5  # chip_smoke.py: K6 against the plain mixed version, of max|plain|


@pytest.mark.parametrize("n", TWIN_NS)
@pytest.mark.parametrize("net", sorted(TWIN_NETS))
@pytest.mark.parametrize("policy", sorted(TWIN_POLICIES))
def test_tiled_twin_under_the_policy(policy, net, n):
    """K6's tiled design (bf16(W) on the quantized streams' rows, the policy's
    rounding in the epilogue) against the plain mixed recurrence, within
    K6_PLAIN_TOL of max|plain| per stream (the same roundings; float32 sums
    in another order), and against JAX's mixed pass within the relative L2
    of test_policy_streams_match_jax."""
    keep, me = TWIN_POLICIES[policy]
    kw = dict(compute_dtype="bfloat16", keep_streams=keep, mixed_elementwise=me)
    spec, jparams, params, x = twin_case(net, n, seed=42, **kw)
    assert spec.mixed
    got = tiled_twin(spec, params, torch.from_numpy(x))
    plain = mlp_taylor_2_reference(spec, params, torch.from_numpy(x))
    want = jax_taylor_2(JSpec(layers=spec.layers, lb=LB, ub=UB, **kw), _jax_net(jparams),
                        jnp.asarray(x))
    for name, g, p, w in zip(("u", "u_x", "u_t", "u_xx"), got, plain, want):
        assert g.dtype == torch.float32 and g.shape == (n, 1)
        err = float((g - p).abs().max())
        assert err <= K6_PLAIN_TOL * float(p.abs().max()), (name, err)
        assert _rel(g, w) <= 1e-3, name


def test_unmixed_spec_ignores_keep_streams():
    """keep_streams and mixed_elementwise on a float32 spec leave the float32
    pass exactly as it is (JAX: _StreamPolicy.quantized is false)."""
    net, x = _torch_net(numpy_params(LAYERS, 27)), torch.from_numpy(numpy_points(50, 28))
    plain = mlp_taylor_2(MLPSpec(layers=LAYERS, lb=LB, ub=UB), net, x)
    for extra in ({"keep_streams": ("xx",)}, {"mixed_elementwise": True},
                  {"compute_dtype": "float32", "keep_streams": ("value", "xx")}):
        spec = MLPSpec(layers=LAYERS, lb=LB, ub=UB, **extra)
        assert not spec.mixed
        assert all(torch.equal(a, b) for a, b in zip(mlp_taylor_2(spec, net, x), plain))


def test_spec_compute_dtype_parsing():
    spec = MLPSpec(layers=LAYERS, lb=LB, ub=UB, compute_dtype="bfloat16")
    assert spec.compute_dtype is torch.bfloat16 and spec.cdtype is torch.bfloat16 and spec.mixed
    assert MLPSpec(layers=LAYERS, lb=LB, ub=UB, compute_dtype=torch.bfloat16) == spec
    assert MLPSpec(layers=LAYERS, lb=LB, ub=UB).cdtype is torch.float32
    for bad in ("int8", "nonsense"):
        with pytest.raises(ValueError, match="compute_dtype"):
            MLPSpec(layers=LAYERS, lb=LB, ub=UB, compute_dtype=bad)
    with pytest.raises(ValueError, match="keep_streams"):
        MLPSpec(layers=LAYERS, lb=LB, ub=UB, compute_dtype="bfloat16", keep_streams=("deriv",))


@pytest.mark.parametrize("spec_kw,match", [
    ({"compute_dtype": "bfloat16", "dtype": torch.float64}, "float32 masters"),
    ({"compute_dtype": "float16"}, "computes in bfloat16"),
    ({"keep_streams": ("xx",)}, "CUDA tensor"),  # plain float32: K1's path, which raises too
    ({"compute_dtype": "bfloat16", "layers": (2, 300, 1)}, "widths up to 256"),
    ({"compute_dtype": "bfloat16"}, "CUDA tensor"),
], ids=["f64-masters", "float16", "unmixed", "too-wide", "cpu-tensor"])
def test_k6_wrapper_raises_never_falls_back(spec_kw, match):
    kw = dict({"layers": LAYERS, "lb": LB, "ub": UB}, **spec_kw)
    spec = MLPSpec(**kw)
    net = _torch_net(numpy_params(spec.layers, 29), spec.dtype)
    x = torch.from_numpy(numpy_points(8, 30))
    cot = [torch.zeros(8, 1) for _ in range(4)]
    counts = lambda: (k_taylor2.LAUNCHES, k_taylor2.BACKWARD_LAUNCHES,  # noqa: E731
                      k_taylor2.MIXED_LAUNCHES, k_taylor2.MIXED_BACKWARD_LAUNCHES)
    before = counts()
    with pytest.raises(ValueError, match=match):
        k_taylor2.taylor2(spec, net, x)
    with pytest.raises(ValueError, match=match):
        k_taylor2.taylor2_backward(spec, net, x, cot)
    assert counts() == before


def test_policy_flags():
    flags = lambda **kw: k_taylor2.policy_flags(  # noqa: E731
        MLPSpec(layers=LAYERS, lb=LB, ub=UB, compute_dtype="bfloat16", **kw))
    assert flags() == 1 | 2 | 4  # the TPU kernel's own case
    assert flags(keep_streams=("xx",)) == 1 | 2
    assert flags(keep_streams=("value", "xx")) == 2
    assert flags(mixed_elementwise=True) == 1 | 2 | 4 | 8


@pytest.mark.parametrize("policy", [{}, {"model.keep_streams": ("xx",)},
                                    {"model.mixed_elementwise": True}],
                         ids=["keep-none", "keep-xx", "max"])
def test_burgers_scale_spec_maps_from_jax(monkeypatch, policy):
    """A JAX burgers_scale problem with a policy and the port's map field for
    field onto MLPSpec."""
    from pinns_tpu.config import override as joverride
    from pinns_tpu.data import datasets as jds
    from pinns_tpu.experiments.presets import PRESETS as JPRESETS
    from pinns_tpu.train import trainer as jtrainer
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as ttrainer

    grid = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port", "burgers_shock.npz")
    with np.load(grid) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T})
    monkeypatch.setattr(jtrainer, "load_burgers_mat", lambda name: ds)
    updates = {"model.compute_dtype": "bfloat16", **policy}
    jspec = jtrainer.build_problem(joverride(JPRESETS["burgers_scale"], updates)).spec
    tspec = ttrainer.build_problem(override(get_preset("burgers_scale"), updates), "cpu").spec
    assert tspec.layers == jspec.layers and tspec.lb == jspec.lb and tspec.ub == jspec.ub
    assert str(tspec.compute_dtype).removeprefix("torch.") == str(jspec.compute_dtype)
    assert tspec.keep_streams == jspec.keep_streams
    assert tspec.mixed_elementwise == jspec.mixed_elementwise
    assert tspec.mixed == jspec.mixed is True
