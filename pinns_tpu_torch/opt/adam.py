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
staircased), each evaluated at Adam's count in float32 as optax does under
XLA on the CPU, bit for bit at every count: XLA folds the constants (the
cosine's argument count * fl(pi / T), its affine part (1 + cos) * fl(0.5 (1 -
alpha)) + alpha as one fused multiply-add; the exponential's exponent count
* fl(1 / T)) and evaluates ``cos`` and ``pow`` by the C library's ``cosf`` and
``powf``, which the schedule calls too (numpy's float32 ``cos`` and
``power`` differ from them by an ulp or more at some counts).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
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


@functools.lru_cache(maxsize=1)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.argtypes, lib.cosf.restype = [ctypes.c_float], ctypes.c_float
    lib.powf.argtypes, lib.powf.restype = [ctypes.c_float, ctypes.c_float], ctypes.c_float
    return lib


def _cosf(a: np.ndarray) -> np.ndarray:
    """The C library's float32 cosine of each entry of ``a``."""
    fn = _libm().cosf
    return np.fromiter((fn(v) for v in a.tolist()), np.float32, a.size)


def _powf(base: np.float32, a: np.ndarray) -> np.ndarray:
    """The C library's float32 ``base ** a`` for each entry of ``a``."""
    fn, b = _libm().powf, float(base)
    return np.fromiter((fn(b, v) for v in a.tolist()), np.float32, a.size)


def _scalar_or_array(fn):
    """``fn`` over a numpy array of counts as a float64 array; over an int
    count as a float."""
    @functools.wraps(fn)
    def call(count):
        counts = np.asarray(count, dtype=np.int64)
        out = fn(counts.reshape(-1)).astype(np.float64)
        return float(out[0]) if counts.ndim == 0 else out.reshape(counts.shape)

    return call


def learning_rate_schedule(cfg) -> Union[float, Callable[[int], float]]:
    """The learning rate of an ``OptimizerConfig``: a float for 'constant',
    else a function of Adam's count (the updates taken so far): an int gives
    a float, an array of counts a float64 array of the float32 rates (the
    schedule's rows take a chunk's in one call)."""
    f32 = np.float32
    lr0, steps = f32(cfg.learning_rate), cfg.schedule_epochs
    if cfg.lr_schedule == "constant":
        return float(cfg.learning_rate)
    if cfg.lr_schedule == "cosine":
        if not steps > 0:
            raise ValueError(f"the cosine schedule needs schedule_epochs > 0, got {steps}")
        alpha = cfg.min_lr_fraction
        step = f32(np.pi) / f32(steps)
        half = f32(0.5) * f32(1 - alpha)

        @_scalar_or_array
        def cosine(counts: np.ndarray) -> np.ndarray:
            c = np.minimum(counts.astype(f32), f32(steps))
            one_plus = f32(1) + _cosf(c * step)
            # (1 + cos) * half + alpha, one rounding: the float64 product of
            # two float32 values is exact
            decayed = (one_plus.astype(np.float64) * np.float64(half)
                       + np.float64(f32(alpha))).astype(f32)
            return decayed * lr0

        return cosine
    if cfg.lr_schedule == "exponential":
        if steps <= 0:
            return float(cfg.learning_rate)
        inv = f32(1) / f32(steps)

        @_scalar_or_array
        def exponential(counts: np.ndarray) -> np.ndarray:
            rate = lr0 * _powf(f32(0.1), counts.astype(f32) * inv)
            return np.where(counts <= 0, lr0, rate).astype(f32)

        return exponential
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
