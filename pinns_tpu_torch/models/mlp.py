"""Tanh MLP with domain-normalized inputs (port of ``pinns_tpu/models/mlp.py``).

Same model as the JAX package: inputs rescaled to [-1, 1] with the domain
bounds lb/ub, tanh hidden layers, linear head, truncated-normal (+/- 2 sigma)
weights with sigma = sqrt(2 / (din + dout)) and zero biases.

The parameter layout is the JAX one: ``params`` is a list of
``{"W": (din, dout), "b": (1, dout)}`` tensors and a layer computes
``h @ W + b`` (not ``nn.Linear``'s transposed weight), so the JAX <-> torch
converter (``pinns_tpu_torch.interop``) is a plain copy and the CUDA kernel
reads weights row-major.

Slice 1 ports the affine-embedding model. Fourier features and trainable
shock paths come with slice 2; the mixed-precision stream policy with slice 3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

Params = List[Dict[str, torch.Tensor]]  # [{'W': (din, dout), 'b': (1, dout)}]


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
        stream policy of the JAX package. Carried so a JAX spec maps field for
        field; ``ops.taylor`` raises on a mixed spec until slice 3.
      fourier / n_paths: embeddings of the JAX package; a spec that sets
        either raises NotImplementedError until slice 2.
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

    def __post_init__(self):
        if self.fourier or self.n_paths:
            raise NotImplementedError(
                "Fourier features and shock-path features are ported with "
                "slice 2 (Euler and the weak form); slice 1 takes the affine "
                "embedding only"
            )
        object.__setattr__(self, "layers", tuple(int(w) for w in self.layers))
        object.__setattr__(self, "lb", tuple(float(v) for v in self.lb))
        object.__setattr__(self, "ub", tuple(float(v) for v in self.ub))
        object.__setattr__(self, "keep_streams", tuple(self.keep_streams))
        bad = set(self.keep_streams) - {"value", "xx"}
        if bad:
            raise ValueError(f"unknown keep_streams {sorted(bad)}")
        if len(self.layers) < 2:
            raise ValueError(f"need at least an input and an output width, got {self.layers}")
        if len(self.lb) != self.layers[0] or len(self.ub) != self.layers[0]:
            raise ValueError(
                f"lb/ub must have length layers[0]={self.layers[0]}, "
                f"got {len(self.lb)}/{len(self.ub)}"
            )

    @property
    def mixed(self) -> bool:
        return self.compute_dtype is not None and self.compute_dtype != self.dtype

    @property
    def in_dim(self) -> int:
        return self.layers[0]

    @property
    def out_dim(self) -> int:
        return self.layers[-1]

    @property
    def n_params(self) -> int:
        return sum(
            din * dout + dout for din, dout in zip(self.layers[:-1], self.layers[1:])
        )


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
    same weights on every device) and are then moved to ``device``.
    """
    params = []
    for din, dout in zip(spec.layers[:-1], spec.layers[1:]):
        std = math.sqrt(2.0 / (din + dout))
        w = std * _truncated_normal((din, dout), generator, spec.dtype)
        params.append(
            {
                "W": w.to(device),
                "b": torch.zeros((1, dout), dtype=spec.dtype, device=device),
            }
        )
    return params


def _bounds(spec: MLPSpec, device: torch.device):
    lb = torch.tensor(spec.lb, dtype=spec.dtype, device=device)
    ub = torch.tensor(spec.ub, dtype=spec.dtype, device=device)
    return lb, ub


def normalize_inputs(spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    """Affine rescale of inputs to [-1, 1], in ``spec.dtype``."""
    lb, ub = _bounds(spec, x.device)
    return 2.0 * (x - lb) / (ub - lb) - 1.0


def input_scale(spec: MLPSpec, device: torch.device) -> torch.Tensor:
    """d(normalized input)/d(raw input) per dimension: 2 / (ub - lb)."""
    lb, ub = _bounds(spec, device)
    return 2.0 / (ub - lb)


def embed_streams(spec: MLPSpec, h: torch.Tensor):
    """Initial Taylor streams of the affine embedding w.r.t. the RAW inputs.

    Returns (h, dx, dt, None): the tangents are the constant (1, 2) rows
    (scale_x, 0) and (0, scale_t), and the second-derivative stream is
    identically zero (None), as in the JAX package's affine branch.
    """
    scale = input_scale(spec, h.device)
    eye = torch.eye(2, dtype=spec.dtype, device=h.device)
    return h, eye[0:1] * scale, eye[1:2] * scale, None


def mlp_apply(spec: MLPSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: normalize -> tanh layers -> linear head. (N, in) -> (N, out)."""
    h = normalize_inputs(spec, x)
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["W"] + layer["b"])
    last = params[-1]
    return h @ last["W"] + last["b"]


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

    def params(self) -> Params:
        return [{"W": w, "b": b} for w, b in zip(self.W, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.spec, self.params(), x)
