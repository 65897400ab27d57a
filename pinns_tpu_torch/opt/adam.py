"""Adam with optax's semantics (``optax.adam`` as ``pinns_tpu/train/trainer.py``
builds it), as a small functional pair, and its learning-rate schedules.

    mu  = (1 - b1) g + b1 mu              nu = (1 - b2) g^2 + b2 nu
    t   = count + 1                       mu_hat = mu / (1 - b1^t)
    nu_hat = nu / (1 - b2^t)              update = -lr mu_hat / (sqrt(nu_hat) + eps)

``AdamState`` carries ``count``, ``mu`` and ``nu`` as optax's
``ScaleByAdamState`` does (``mu``/``nu`` are trees shaped like the params), so
``pinns_tpu_torch.interop`` converts it both ways. ``count`` is a host int:
the step count never lives on the device in the port. This is the plain
version of the Adam stage of the fused CUDA step (``csrc/fused_step.cu``).

:func:`learning_rate_schedule` ports ``_make_optimizer``'s schedules
(``pinns_tpu/train/trainer.py:793-809``): 'constant', 'cosine' (optax's
``cosine_decay_schedule`` with ``alpha = min_lr_fraction``) and 'exponential'
(optax's ``exponential_decay`` by 0.1 over ``schedule_epochs``, not
staircased), each evaluated at Adam's count in float32 as optax does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

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


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _leaves_like(tree, other) -> list:
    """The leaves of ``other`` in the order of ``tree``'s (dict keys matched
    by name, whatever their order in either)."""
    out = []
    tree_map(lambda _, x: out.append(x), tree, other)
    return out


def adam_update(grads, state: AdamState, lr: Union[float, torch.Tensor], b1: float = B1,
                b2: float = B2, eps: float = EPS, bias: Optional[Tuple] = None):
    """(updates, new state) for ``grads``; add the updates to the params with
    :func:`apply_updates`. Each stage is one multi-tensor op over all leaves
    (``torch._foreach_*``): per element the arithmetic of the formulas above,
    rounded after every operation, in a few launches for the whole tree.

    ``lr`` is a float or a 0-d tensor on the leaves' device, in their dtype;
    ``bias`` None takes :func:`bias_corrections` at ``state.count``, else it
    is (1 - b1^t, 1 - b2^t) as such 0-d tensors. The generic step passes
    tensors read from its epoch schedule on the device
    (``train.schedule``), so that nothing of an epoch is a host value. The
    two forms agree bit for bit on the CPU (``tests/test_torch_generic_chunk.
    py``); on the card ``chip_smoke.py`` (phase 41) reports whether they do."""
    f = torch
    g, m, v = tree_leaves(grads), _leaves_like(grads, state.mu), _leaves_like(grads, state.nu)
    mu = f._foreach_add(f._foreach_mul(g, 1.0 - b1), f._foreach_mul(m, b1))
    nu = f._foreach_add(f._foreach_mul(f._foreach_mul(g, g), 1.0 - b2), f._foreach_mul(v, b2))
    bc1, bc2 = bias_corrections(state.count, b1, b2) if bias is None else bias
    den = f._foreach_add(f._foreach_sqrt(f._foreach_div(nu, bc2)), eps)
    neg_lr = torch.neg(lr) if isinstance(lr, torch.Tensor) else -lr
    updates = f._foreach_mul(f._foreach_div(f._foreach_div(mu, bc1), den), neg_lr)
    return _unflatten(grads, updates), AdamState(
        count=state.count + 1, mu=_unflatten(grads, mu), nu=_unflatten(grads, nu))


def apply_updates(params, updates):
    return _unflatten(params, torch._foreach_add(tree_leaves(params),
                                                 _leaves_like(params, updates)))


def learning_rate_schedule(cfg) -> Union[float, Callable[[int], float]]:
    """The learning rate of an ``OptimizerConfig``: a float for 'constant',
    else a function of Adam's count (the updates taken so far)."""
    f32 = np.float32
    lr0, steps = f32(cfg.learning_rate), cfg.schedule_epochs
    if cfg.lr_schedule == "constant":
        return float(cfg.learning_rate)
    if cfg.lr_schedule == "cosine":
        if not steps > 0:
            raise ValueError(f"the cosine schedule needs schedule_epochs > 0, got {steps}")
        alpha = cfg.min_lr_fraction

        def cosine(count: int) -> float:
            c = min(f32(count), f32(steps))
            decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps)))
            return float(lr0 * (f32(1 - alpha) * decay + f32(alpha)))

        return cosine
    if cfg.lr_schedule == "exponential":
        if steps <= 0:
            return float(cfg.learning_rate)

        def exponential(count: int) -> float:
            if count <= 0:
                return float(lr0)
            return float(lr0 * np.power(f32(0.1), f32(count) / f32(steps)))

        return exponential
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
