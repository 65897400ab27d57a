"""Adam with optax's semantics (``optax.adam`` as ``pinns_tpu/train/trainer.py``
builds it for the 'constant' schedule), as a small functional pair.

    mu  = (1 - b1) g + b1 mu              nu = (1 - b2) g^2 + b2 nu
    t   = count + 1                       mu_hat = mu / (1 - b1^t)
    nu_hat = nu / (1 - b2^t)              update = -lr mu_hat / (sqrt(nu_hat) + eps)

``AdamState`` carries ``count``, ``mu`` and ``nu`` as optax's
``ScaleByAdamState`` does (``mu``/``nu`` are trees shaped like the params), so
``pinns_tpu_torch.interop`` converts it both ways. ``count`` is a host int:
the step count never lives on the device in the port. This is the plain
version of the Adam stage of the fused CUDA step (``csrc/fused_step.cu``).
The cosine and exponential schedules are not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    return AdamState(count=0, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def bias_corrections(count: int, b1: float = B1, b2: float = B2):
    """(1 - b1^t, 1 - b2^t) at t = count + 1, in float32 as optax takes them."""
    t = np.float32(count + 1)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def adam_update(grads, state: AdamState, lr: float, b1: float = B1, b2: float = B2,
                eps: float = EPS):
    """(updates, new state) for ``grads``; add the updates to the params with
    :func:`apply_updates`."""
    mu = tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads, state.nu)
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    updates = tree_map(
        lambda m, v: -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)), mu, nu
    )
    return updates, AdamState(count=state.count + 1, mu=mu, nu=nu)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
