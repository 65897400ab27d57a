"""Collocation-point samplers (port of ``pinns_tpu/data/sampling.py``).

``uniform_box`` and ``latin_hypercube`` draw from an explicit
``torch.Generator``, as the JAX functions draw from an explicit key; the two
libraries give different numbers from one seed, so the tests feed both
packages the same points instead.

The per-epoch resampling of the training step draws with ``philox_uniform``:
counter-based Philox-4x32-10 (Salmon et al., SC'11), keyed by the run's seed
and indexed by (point, epoch). It needs no state between epochs, gives the
same bits on every device, and is what the fused CUDA step
(``csrc/fused_step.cu``) computes in its tail, so the plain step and the kernel
draw the same points for the same (seed, epoch).
"""

from __future__ import annotations

from typing import Sequence

import torch

from pinns_tpu_torch.device import constant

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments


def scale_to_bounds(unit: torch.Tensor, lb, ub) -> torch.Tensor:
    """Map unit-cube samples to the box [lb, ub]."""
    lb = constant(lb, unit.dtype, unit.device)
    ub = constant(ub, unit.dtype, unit.device)
    return lb + (ub - lb) * unit


def uniform_box(
    generator: torch.Generator, n: int, lb, ub, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Uniform sample of n points in the box [lb, ub]: (n, len(lb)). The draw
    is made on the generator's device and then moved to ``device``."""
    lb = torch.as_tensor(lb, dtype=dtype)
    u = torch.rand((n, lb.shape[0]), generator=generator, dtype=dtype,
                   device=generator.device)
    return scale_to_bounds(u.to(device), lb, ub)


def latin_hypercube(
    generator: torch.Generator, n: int, dim: int, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Latin hypercube sample on the unit cube, (n, dim): each dimension is an
    independent random permutation of the n strata, with a uniform draw inside
    each stratum."""
    u = torch.rand((n, dim), generator=generator, dtype=dtype, device=generator.device)
    cols = [
        torch.randperm(n, generator=generator, device=generator.device).to(dtype)
        for _ in range(dim)
    ]
    return ((torch.stack(cols, dim=1) + u) / n).to(device)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a * b, in int64 tensors
    (b < 2**32; split in 16-bit halves so no product overflows int64)."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence[int]):
    """Philox-4x32 with 10 rounds on int64 tensors holding uint32 words.

    counter: four broadcastable tensors (c0, c1, c2, c3); key: (k0, k1) ints.
    Returns the four output words as int64 tensors in [0, 2**32).
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK for c in counter)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(
    seed: int, epoch: int, n: int, lb, ub, dtype=torch.float32, device="cpu", row0: int = 0
) -> torch.Tensor:
    """(n, 2) points uniform in [lb, ub): point i of ``epoch`` takes the first
    two words of Philox(counter=(i, epoch, 0, 0), key=(seed low, seed high)),
    keeps their top 24 bits as u = bits * 2**-24 in [0, 1), and maps
    x = lb + (ub - lb) * u in ``dtype``, rounding after each operation (the
    kernel does the same, without a fused multiply-add). ``row0`` gives rows
    [row0, row0 + n) of the draw: a data-parallel rank's rows, so that the
    ranks' draws together are the one-card draw bit for bit."""
    if len(lb) != 2 or len(ub) != 2:
        raise ValueError("philox_uniform draws (x, t) points: lb/ub need 2 entries")
    if row0 < 0 or row0 + n > 1 << 32:
        raise ValueError(f"philox_uniform: rows [{row0}, {row0 + n}) outside the 32-bit counter")
    idx = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    w0, w1, _, _ = philox4x32_10(
        (idx, zero + (epoch & _MASK), zero + ((epoch >> 32) & _MASK), zero),
        (seed & _MASK, (seed >> 32) & _MASK),
    )
    u = torch.stack([w0 >> 8, w1 >> 8], dim=1).to(dtype) * (2.0 ** -24)
    lo = constant(lb, dtype, device)
    hi = constant(ub, dtype, device)
    return lo + (hi - lo) * u
