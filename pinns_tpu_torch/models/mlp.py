"""Tanh MLP with domain-normalized inputs (port of ``pinns_tpu/models/mlp.py``).

Same model as the JAX package: inputs rescaled to [-1, 1] with the domain
bounds lb/ub, tanh hidden layers, linear head, truncated-normal (+/- 2 sigma)
weights with sigma = sqrt(2 / (din + dout)) and zero biases.

The parameter layout is the JAX one: ``params`` is a list of
``{"W": (din, dout), "b": (1, dout)}`` tensors and a layer computes
``h @ W + b`` (not ``nn.Linear``'s transposed weight), so the JAX <-> torch
converter (``pinns_tpu_torch.interop``) is a plain copy and the CUDA kernel
reads weights row-major.

Slice 1 ports the affine-embedding model; slice 3 the mixed-precision
stream policy (``compute_dtype``, ``keep_streams``, ``mixed_elementwise``, read
by ``ops.taylor``); slice 2b-ii the trainable shock-path features
(``n_paths``): K features phi_k = tanh(a_k (x_n - s_k(t_n))) of the normalized
coordinates appended to the first layer's input, s_k a trainable polynomial
of degree ``path_degree`` in normalized time (coefficients ``path_c`` (K,
D + 1)) and a_k a trainable sharpness (``path_a`` (K,)), both on
``params[0]``; and slice 2b-iii the Fourier features (``fourier``): the rows
of a fixed frequency matrix B (F, 2), whose features sin z, cos z, z = h 2 pi
B^T of the normalized coordinates h follow them in the first layer's input,
``[h, sin z, cos z, phi]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pinns_tpu_torch.device import constant

# [{'W': (din, dout), 'b': (1, dout)}, ...]; with shock paths params[0] also
# holds 'path_c' (K, D + 1) and 'path_a' (K,)
Params = List[Dict[str, torch.Tensor]]
PATH_KEYS = ("path_c", "path_a")


def _float_dtype(value) -> torch.dtype:
    """A torch floating dtype from a torch dtype or its name ("bfloat16")."""
    dtype = getattr(torch, value, None) if isinstance(value, str) else value
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must be a floating dtype, got {value!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static description of a domain-normalized tanh MLP.

    Attributes:
      layers: layer widths, e.g. (2, 20, ..., 20, 1); layers[0] is the input
        dimension (x, t), layers[-1] the number of PDE fields.
      lb / ub: domain bounds per input dimension (held as Python floats, as
        the JAX spec holds them; cast to ``dtype`` where used).
      dtype: parameter and compute dtype.
      compute_dtype / keep_streams / mixed_elementwise: the mixed-precision
        stream policy of the JAX package (``ops.taylor._StreamPolicy``).
        ``compute_dtype`` is None or a float dtype, given as a torch dtype or
        its name ("bfloat16"); the spec is mixed only when it differs from
        ``dtype``.
      fourier: the rows of the Fourier features' frequency matrix B (F,
        in_dim) as a nested tuple (:func:`fourier_matrix`); empty: none.
      n_paths / path_degree / path_sharpness: the trainable shock-path
        features (module docstring): their number K, the degree D of each
        path's polynomial in normalized time, the initial sharpness. They
        assume (x, t) inputs.
    """

    layers: tuple
    lb: tuple
    ub: tuple
    dtype: Any = torch.float32
    compute_dtype: Any = None
    keep_streams: tuple = ()
    mixed_elementwise: bool = False
    fourier: tuple = ()
    n_paths: int = 0
    path_degree: int = 2
    path_sharpness: float = 8.0

    def __post_init__(self):
        object.__setattr__(self, "fourier",
                           tuple(tuple(float(v) for v in row) for row in self.fourier))
        object.__setattr__(self, "n_paths", int(self.n_paths))
        object.__setattr__(self, "path_degree", int(self.path_degree))
        object.__setattr__(self, "path_sharpness", float(self.path_sharpness))
        object.__setattr__(self, "layers", tuple(int(w) for w in self.layers))
        object.__setattr__(self, "lb", tuple(float(v) for v in self.lb))
        object.__setattr__(self, "ub", tuple(float(v) for v in self.ub))
        if self.compute_dtype is not None:
            object.__setattr__(self, "compute_dtype", _float_dtype(self.compute_dtype))
        object.__setattr__(self, "keep_streams", tuple(self.keep_streams))
        bad = set(self.keep_streams) - {"value", "xx"}
        if bad:
            raise ValueError(f"unknown keep_streams {sorted(bad)}")
        if len(self.layers) < 2:
            raise ValueError(f"need at least an input and an output width, got {self.layers}")
        if self.fourier and any(len(row) != self.layers[0] for row in self.fourier):
            raise ValueError(f"fourier rows must have length layers[0]={self.layers[0]}")
        if len(self.lb) != self.layers[0] or len(self.ub) != self.layers[0]:
            raise ValueError(
                f"lb/ub must have length layers[0]={self.layers[0]}, "
                f"got {len(self.lb)}/{len(self.ub)}"
            )
        if self.n_paths < 0 or self.path_degree < 0:
            raise ValueError("n_paths and path_degree must be >= 0")
        if self.n_paths and self.layers[0] != 2:
            raise ValueError("shock-path features assume (x, t) inputs (in_dim == 2)")

    @property
    def cdtype(self):
        """Residual-path compute dtype (== dtype unless mixing)."""
        return self.dtype if self.compute_dtype is None else self.compute_dtype

    @property
    def mixed(self) -> bool:
        return self.cdtype != self.dtype

    @property
    def in_dim(self) -> int:
        return self.layers[0]

    @property
    def n_fourier(self) -> int:
        return len(self.fourier)

    @property
    def embed_dim(self) -> int:
        """First-layer input width: the raw coordinates, the sin/cos pairs and
        the path features."""
        return self.in_dim + 2 * self.n_fourier + self.n_paths

    @property
    def widths(self) -> tuple:
        """The layers' widths with the first layer's input embedded."""
        return (self.embed_dim,) + self.layers[1:]

    @property
    def out_dim(self) -> int:
        return self.layers[-1]

    @property
    def n_path_params(self) -> int:
        return self.n_paths * (self.path_degree + 2)  # path_c + path_a

    @property
    def n_params(self) -> int:
        w = self.widths
        return sum(din * dout + dout for din, dout in zip(w[:-1], w[1:])) + self.n_path_params


def _truncated_normal(shape, generator: torch.Generator, dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] by inverse-CDF sampling (exactly
    the law of ``jax.random.truncated_normal(-2, 2)``; the bits differ)."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return z.clamp_(-2.0, 2.0).to(dtype)


def init_mlp(
    spec: MLPSpec, generator: torch.Generator, device: torch.device
) -> Params:
    """Initialize params: truncated-normal W (std sqrt(2/(din+dout))), zero b.

    The draws come from ``generator`` (a CPU generator, so a seed gives the
    same weights on every device) and are then moved to ``device``. Shock
    paths start as JAX's do (``pinns_tpu/models/mlp.py:194-206``, no draw):
    constant-in-time fronts at 2 (k + 1/2) / K - 1 in normalized x, sharpness
    ``path_sharpness``.
    """
    params = []
    widths = spec.widths
    for din, dout in zip(widths[:-1], widths[1:]):
        std = math.sqrt(2.0 / (din + dout))
        w = std * _truncated_normal((din, dout), generator, spec.dtype)
        params.append(
            {
                "W": w.to(device),
                "b": torch.zeros((1, dout), dtype=spec.dtype, device=device),
            }
        )
    if spec.n_paths:
        k = spec.n_paths
        c = torch.zeros((k, spec.path_degree + 1), dtype=spec.dtype)
        c[:, 0] = (2.0 * (torch.arange(k, dtype=spec.dtype) + 0.5) / k) - 1.0
        params[0]["path_c"] = c.to(device)
        params[0]["path_a"] = torch.full((k,), spec.path_sharpness, dtype=spec.dtype,
                                         device=device)
    return params


def _bounds(spec: MLPSpec, device: torch.device):
    return constant(spec.lb, spec.dtype, device), constant(spec.ub, spec.dtype, device)


def normalize_inputs(spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    """Affine rescale of inputs to [-1, 1], in ``spec.dtype``."""
    lb, ub = _bounds(spec, x.device)
    return 2.0 * (x - lb) / (ub - lb) - 1.0


def input_scale(spec: MLPSpec, device: torch.device) -> torch.Tensor:
    """d(normalized input)/d(raw input) per dimension: 2 / (ub - lb)."""
    lb, ub = _bounds(spec, device)
    return 2.0 / (ub - lb)


def fourier_matrix(n_features: int, in_dim: int = 2, sigma: float = 3.0, seed: int = 0
                   ) -> tuple:
    """Frequency matrix B ~ N(0, sigma^2), shape (F, in_dim), as the nested
    tuple ``MLPSpec.fourier`` takes; deterministic in ``seed`` (the port's
    copy of ``pinns_tpu/models/mlp.py::fourier_matrix``: the same numpy draw,
    so the same B bit for bit)."""
    rng = np.random.default_rng(seed)
    b = sigma * rng.standard_normal((n_features, in_dim))
    return tuple(tuple(float(v) for v in row) for row in b)


def fourier_frequencies(spec: MLPSpec) -> np.ndarray:
    """2 pi B^T, (in_dim, F) in ``spec.dtype``, rounded as the JAX package
    rounds it (``_fourier_b``: B in the dtype, times 2 pi in the dtype)."""
    dtype = np.float64 if spec.dtype == torch.float64 else np.float32
    b = np.asarray(spec.fourier, dtype=dtype).T
    return dtype(2.0 * math.pi) * b


def fourier_streams(spec: MLPSpec, h: torch.Tensor):
    """The Fourier features of the NORMALIZED coordinates h and their streams
    w.r.t. the RAW inputs (``pinns_tpu/models/mlp.py:313-330``, in its
    operation order): z = h 2 pi B^T, zx = scale_x 2 pi B[:, 0], zt = scale_t
    2 pi B[:, 1]. Returns the (N, 2F) values [sin z, cos z], x streams [cos z
    zx, -sin z zx], t streams [cos z zt, -sin z zt] and xx streams [-sin z zx
    zx, -cos z zx zx]."""
    bt = constant(fourier_frequencies(spec), spec.dtype, h.device)
    scale = input_scale(spec, h.device)
    z = h @ bt
    sin_z, cos_z = torch.sin(z), torch.cos(z)
    zx = scale[0] * bt[0]
    zt = scale[1] * bt[1]
    cat = lambda a, b: torch.cat([a, b], dim=1)  # noqa: E731
    return (cat(sin_z, cos_z), cat(cos_z * zx, -sin_z * zx), cat(cos_z * zt, -sin_z * zt),
            cat(-sin_z * zx * zx, -cos_z * zx * zx))


def path_streams(spec: MLPSpec, layer0: Dict[str, torch.Tensor], h: torch.Tensor):
    """Shock-path features of the NORMALIZED coordinates h = (x_n, t_n) and
    their streams w.r.t. the RAW inputs (``pinns_tpu/models/mlp.py:242-275``,
    in its operation order):

      phi_k = tanh(z_k), z_k = a_k (x_n - s_k(t_n)), s_k(t_n) = sum_j c_kj t_n^j

    Returns (phi, phi_x, phi_t, phi_xx), each (N, K): phi' = 1 - phi^2,
    phi'' = -2 phi phi', the time chain through s'(t_n), and the input
    rescale's factors."""
    c, a = layer0["path_c"], layer0["path_a"]
    scale = input_scale(spec, h.device)
    xn, tn = h[:, 0:1], h[:, 1:2]
    deg = spec.path_degree
    powers = torch.cat([tn ** j for j in range(deg + 1)], dim=1)  # (N, D+1); t^0 = 1
    s = powers @ c.T
    if deg >= 1:
        dpow = torch.cat([float(j) * tn ** (j - 1) for j in range(1, deg + 1)], dim=1)
        sp = dpow @ c[:, 1:].T
    else:
        sp = torch.zeros_like(s)
    z = a * (xn - s)
    phi = torch.tanh(z)
    d1 = 1.0 - phi * phi
    d2 = -2.0 * phi * d1
    zx = a * scale[0]  # (K,): constant per path
    zt = -(a * scale[1]) * sp  # (N, K)
    return phi, d1 * zx, d1 * zt, d2 * (zx * zx)


def path_backward_reference(spec: MLPSpec, layer0: Dict[str, torch.Tensor], h: torch.Tensor,
                            gv: torch.Tensor, gx: Optional[torch.Tensor] = None,
                            gt: Optional[torch.Tensor] = None,
                            gxx: Optional[torch.Tensor] = None):
    """(d path_c, d path_a) of sum over points of gv . phi + gx . phi_x +
    gt . phi_t + gxx . phi_xx, the adjoints (N, K) of :func:`path_streams`'
    outputs (gx, gt, gxx None: zero), by the chain rule the kernels K2, K7a
    and K5 apply (``csrc/paths.cuh``). With d1 = 1 - phi^2, d2 = -2 phi d1,
    zx = a sx, zt = -a st s':

      gz = gv d1 + d2 (gx zx + gt zt) + gxx d1 (6 phi^2 - 2) zx^2
      d a   = sum gz (x_n - s) + d1 (gx sx - gt st s') + gxx 2 d2 a sx^2
      d c_j = sum -gz a t_n^j - [j >= 1] gt d1 a st j t_n^(j-1)
    """
    c, a = layer0["path_c"], layer0["path_a"]
    scale = input_scale(spec, h.device)
    xn, tn = h[:, 0:1], h[:, 1:2]
    deg = spec.path_degree
    powers = torch.cat([tn ** j for j in range(deg + 1)], dim=1)  # (N, D+1)
    s = powers @ c.T
    jp = powers[:, :deg] * torch.arange(1, deg + 1, dtype=h.dtype, device=h.device)
    sp = jp @ c[:, 1:].T if deg >= 1 else torch.zeros_like(s)
    phi = torch.tanh(a * (xn - s))
    d1 = 1.0 - phi * phi
    d2 = -2.0 * phi * d1
    gx = torch.zeros_like(gv) if gx is None else gx
    gt = torch.zeros_like(gv) if gt is None else gt
    zx = a * scale[0]
    gz = gv * d1 + d2 * (gx * zx + gt * (-(a * scale[1]) * sp))
    if gxx is not None:
        gz = gz + gxx * d1 * (6.0 * phi * phi - 2.0) * zx * zx
    da = gz * (xn - s) + d1 * (gx * scale[0] - gt * scale[1] * sp)
    if gxx is not None:
        da = da + gxx * 2.0 * d2 * a * scale[0] * scale[0]
    da = da.sum(dim=0)
    dc = -((gz * a).T @ powers)
    if deg >= 1:
        dc[:, 1:] = dc[:, 1:] - (gt * d1 * a * scale[1]).T @ jp
    return dc, da


def embed_inputs(spec: MLPSpec, h: torch.Tensor,
                 layer0: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """[h, sin z, cos z, phi]: the first layer's input; h itself without
    Fourier and path features."""
    out = [h]
    if spec.fourier:
        bt = constant(fourier_frequencies(spec), spec.dtype, h.device)
        z = h @ bt
        out += [torch.sin(z), torch.cos(z)]
    if spec.n_paths:
        out.append(path_streams(spec, layer0, h)[0])
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def embed_streams(spec: MLPSpec, h: torch.Tensor,
                  layer0: Optional[Dict[str, torch.Tensor]] = None):
    """Initial Taylor streams of the embedding w.r.t. the RAW inputs
    (``pinns_tpu/models/mlp.py:291``).

    Returns (h, dx, dt, dxx). For the affine embedding the tangents are the
    constant (1, 2) rows (scale_x, 0) and (0, scale_t), and the
    second-derivative stream is identically zero (None), as in the JAX
    package's affine branch. With Fourier or shock-path features (``layer0``
    = params[0] carries the paths) every stream is per point, (N,
    embed_dim): the coordinates' columns, then the Fourier features'
    (:func:`fourier_streams`), then the path features' (:func:`path_streams`).
    """
    scale = input_scale(spec, h.device)
    eye = torch.eye(2, dtype=spec.dtype, device=h.device)
    dx, dt = eye[0:1] * scale, eye[1:2] * scale
    if not spec.n_paths and not spec.fourier:
        return h, dx, dt, None
    streams = [[h], [dx.expand_as(h)], [dt.expand_as(h)], [torch.zeros_like(h)]]
    if spec.fourier:
        for acc, part in zip(streams, fourier_streams(spec, h)):
            acc.append(part)
    if spec.n_paths:
        for acc, part in zip(streams, path_streams(spec, layer0, h)):
            acc.append(part)
    return tuple(torch.cat(acc, dim=1) for acc in streams)


def mlp_apply_reference(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The plain forward pass: normalize -> [Fourier and path features] -> tanh layers ->
    linear head, in ``spec.dtype`` on ``x``'s device. (N, in) -> (N, out)."""
    h = embed_inputs(spec, normalize_inputs(spec, x), params[0])
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["W"] + layer["b"])
    last = params[-1]
    return h @ last["W"] + last["b"]


def mlp_apply(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: normalize -> [path features] -> tanh layers -> linear
    head. (N, in) -> (N, out).

    A CPU tensor takes the plain version (:func:`mlp_apply_reference`); any
    other goes to the fused forward kernel K5, differentiable in the params
    through its backward kernel (``ops.kernels.mlp_forward``), which raises
    on what it cannot take.
    """
    if x.device.type == "cpu":
        return mlp_apply_reference(spec, params, x)
    from pinns_tpu_torch.ops.kernels.mlp_forward import mlp_apply_kernel

    return mlp_apply_kernel(spec, params, x)


class MLP(nn.Module):
    """The tanh MLP as an ``nn.Module`` holding the JAX-layout layers.

    ``params()`` returns the list-of-dicts view the functional API takes, so
    ``MLP(...)(x)`` and ``mlp_apply(spec, mlp.params(), x)`` are one
    computation.
    """

    def __init__(
        self,
        spec: MLPSpec,
        *,
        device: torch.device,
        params: Optional[Params] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.spec = spec
        if params is None:
            if generator is None:
                raise ValueError("MLP needs either params or a torch.Generator")
            params = init_mlp(spec, generator, device)
        self.W = nn.ParameterList(nn.Parameter(p["W"].to(device)) for p in params)
        self.b = nn.ParameterList(nn.Parameter(p["b"].to(device)) for p in params)
        self.path_c = self.path_a = None
        if spec.n_paths:
            self.path_c = nn.Parameter(params[0]["path_c"].to(device))
            self.path_a = nn.Parameter(params[0]["path_a"].to(device))

    def params(self) -> Params:
        out = [{"W": w, "b": b} for w, b in zip(self.W, self.b)]
        if self.spec.n_paths:
            out[0].update(path_c=self.path_c, path_a=self.path_a)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.spec, self.params(), x)
