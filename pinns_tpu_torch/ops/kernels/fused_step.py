"""Wrapper of the fused Adam-epoch CUDA kernel (``csrc/fused_step.cu``), the
step factory the trainer uses on a CUDA device, and the kernel's algorithm in
plain PyTorch.

Replaces the TPU kernel ``make_fused_adam_step`` (``_step_kernel``;
``pinns_tpu/ops/pallas/fused_step.py`` at git ``3266821^``, lines 49-440):
one Adam epoch of a Burgers strong-form configuration, from the loss and its
gradient through Adam, resampling and the ADMM z/dual update to the metrics.
The plain version is the plain step ``train.trainer.make_adam_step``; the
CPU tests hold it against JAX and ``chip_smoke.py`` holds the kernel against
it on the card. ``loss_and_grad_reference`` is the kernel's hand-written
reverse mode in plain PyTorch, held against ``torch.autograd`` by the CPU
tests: the guard on the math the CUDA code implements.

What bounds the kernel on the H100, and the design, are in the header of
``csrc/fused_step.cu``: four launches per epoch, per-block partial gradients
reduced in block order (bit-for-bit repeatable), pre-activation streams kept in
an L2-resident scratch for the backward.

The wrapper validates what the kernel assumes and raises otherwise; on a CPU
tensor it raises too. It never falls back to the plain step.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinns_tpu_torch.models.mlp import MLPSpec, Params
from pinns_tpu_torch.ops.kernels import build
from pinns_tpu_torch.ops.kernels.taylor2 import pack_params, taylor2_backward_reference
from pinns_tpu_torch.opt.adam import B1, B2, EPS, AdamState, bias_corrections

LAUNCHES = 0  # kernel launches (one per epoch) in this process; chip_smoke.py reads it
_launches_lock = threading.Lock()

KINDS = {"admm": 0, "mean_sq": 1, "l2_sq_norm": 2, "l1_sq_norm": 3}
MAX_WIDTH = 256
MAX_LAYERS = 32
_GRAD_SMEM = 200 * 1024
_TAIL_SMEM = 112 * 1024
_MAX_TILE = 64
# argument slots, in the order of the enums in csrc/fused_step.cu
_PTRS = ("params", "mu", "nu", "x_data", "u_data", "colloc", "z", "dual", "new_colloc",
         "params_out", "mu_out", "nu_out", "colloc_out", "z_out", "dual_out", "metrics",
         "grad_out", "partials", "pstore", "tail_partials")
_FLOATS = ("lb0", "lb1", "ub0", "ub1", "lam1", "lam2", "rho", "lr", "one_minus_b1", "b1",
           "one_minus_b2", "b2", "eps", "bc1", "bc2", "threshold")
_INTS = ("n_u", "n_f", "kind", "explicit_inner", "tile", "tail_tile", "seed", "epoch", "device")


def fused_step_supported(exp, spec: MLPSpec) -> List[str]:
    """Why ``exp`` is outside the kernel's scope (empty when it is inside).

    The scope of the TPU kernel (``fused_step.py:49-76``) plus what that
    check left implicit: the strong form without entropy, gradient or causal
    weighting, one output, widths up to 256, and no per-run rho override
    (checked per step).
    """
    lo, s = exp.loss, exp.sampling
    reasons = [
        (exp.pde.kind != "burgers", f"pde.kind={exp.pde.kind!r}"),
        (exp.optimizer.lr_schedule != "constant", "a learning-rate schedule"),
        (exp.pde.train_coeffs, "trainable PDE coefficients"),
        (s.strategy != "resample_uniform", f"sampling.strategy={s.strategy!r}"),
        (s.microbatch > 1, "microbatching"),
        (s.t_curriculum_epochs > 0, "the time curriculum"),
        (lo.data_kind != "mse_sum", f"loss.data_kind={lo.data_kind!r}"),
        (lo.data_weight != 1.0 or lo.residual_weight != 1.0, "loss weights other than 1"),
        (lo.residual_kind not in KINDS, f"loss.residual_kind={lo.residual_kind!r}"),
        (lo.admm_update_points != "resampled", "admm_update_points='current'"),
        (lo.admm_form != "strong", "the weak-form ADMM residual"),
        (lo.entropy_weight > 0.0 or lo.grad_weight_kappa != 0.0 or lo.causal_eps > 0.0,
         "entropy, gradient or causal weighting"),
        (spec.dtype != torch.float32 or spec.mixed, "a dtype other than float32"),
        (spec.in_dim != 2 or spec.out_dim != 1, f"widths {spec.layers} (needs 2 -> ... -> 1)"),
        (max(spec.layers) > MAX_WIDTH, f"a width above {MAX_WIDTH}"),
        (len(spec.layers) - 1 > MAX_LAYERS or len(spec.layers) < 3,
         f"{len(spec.layers) - 1} layers (needs 2 to {MAX_LAYERS})"),
    ]
    return [why for bad, why in reasons if bad]


def _tile(widest: int, n_buffers: int, budget: int) -> int:
    """Largest multiple of 4 points (at most _MAX_TILE) whose stream buffers
    (n_buffers x 4 streams x widest rows x (tile + 4) floats) fit the budget."""
    tile = budget // (4 * n_buffers * 4 * widest) - 4
    return min(_MAX_TILE, tile - tile % 4)


def launch_config(layers: Sequence[int]) -> Tuple[int, int]:
    """(grad-kernel tile, tail-kernel tile) in points per block."""
    widest = max(layers)
    return _tile(widest, 3, _GRAD_SMEM), _tile(widest, 2, _TAIL_SMEM)


def _lib():
    lib = build.load_library("fused_step")
    if not getattr(lib, "_pinns_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pinns_fused_step.argtypes = [p, i, p, p, p, p]
        lib.pinns_fused_step.restype = i
        lib.pinns_fused_step_sizes.argtypes = [p, p, p]
        lib.pinns_fused_step_sizes.restype = i
        lib.pinns_fused_step_error_string.argtypes = [i]
        lib.pinns_fused_step_error_string.restype = ctypes.c_char_p
        sizes = [ctypes.c_int() for _ in range(3)]
        lib.pinns_fused_step_sizes(*(ctypes.byref(s) for s in sizes))
        want = (len(_PTRS), len(_FLOATS), len(_INTS))
        if tuple(s.value for s in sizes) != want:
            raise RuntimeError(f"fused_step.cu argument slots {[s.value for s in sizes]} "
                               f"!= the wrapper's {list(want)}")
        lib._pinns_typed = True
    return lib


def fused_adam_step(
    spec: MLPSpec,
    params: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    count: int,
    x_data: torch.Tensor,
    u_data: torch.Tensor,
    colloc: torch.Tensor,
    z: Optional[torch.Tensor],
    dual: Optional[torch.Tensor],
    *,
    kind: str,
    lam1: float,
    lam2: float,
    rho: float,
    lr: float,
    explicit_inner: bool,
    seed: int,
    epoch: int,
    new_colloc: Optional[torch.Tensor] = None,
    metrics_out: Optional[torch.Tensor] = None,
    want_grad: bool = False,
) -> Dict[str, torch.Tensor]:
    """One Adam epoch in one call of the CUDA step (four launches).

    ``params``/``mu``/``nu`` are flat float32 buffers in ``pack_params`` order;
    ``count`` is Adam's step count before this step. The new batch is the
    Philox draw of (``seed``, ``epoch``), or ``new_colloc`` when given.
    Returns new tensors {params, mu, nu, colloc, z, dual, metrics, grad}; the
    inputs are not modified. ``metrics`` (7 floats, ``METRIC_KEYS`` order) is
    ``metrics_out`` when given; ``grad`` is the reduced gradient the Adam
    stage used when ``want_grad``, else None.
    """
    global LAUNCHES
    dev = colloc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_step kernel needs CUDA tensors, got device {dev}")
    layers = spec.layers
    n_params = spec.n_params
    n_f, n_u = colloc.shape[0], x_data.shape[0]
    if kind not in KINDS:
        raise ValueError(f"fused_step kernel: residual kind {kind!r} not in {sorted(KINDS)}")
    if (kind == "admm") != (z is not None and dual is not None):
        raise ValueError("fused_step kernel: z/dual are given exactly when kind == 'admm'")
    if spec.in_dim != 2 or spec.out_dim != 1 or max(layers) > MAX_WIDTH \
            or not 2 <= len(layers) - 1 <= MAX_LAYERS:
        raise ValueError(f"fused_step kernel: unsupported widths {layers}")
    shapes = {"params": (params, (n_params,)), "mu": (mu, (n_params,)),
              "nu": (nu, (n_params,)), "x_data": (x_data, (n_u, 2)),
              "u_data": (u_data, (n_u, 1)), "colloc": (colloc, (n_f, 2))}
    if z is not None:
        shapes.update(z=(z, (n_f, 1)), dual=(dual, (n_f, 1)))
    if new_colloc is not None:
        shapes["new_colloc"] = (new_colloc, (n_f, 2))
    if metrics_out is not None:
        shapes["metrics_out"] = (metrics_out, (7,))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"fused_step kernel: {name} must be contiguous float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n_f < 1 or n_u < 1:
        raise ValueError("fused_step kernel needs at least one collocation and one data point")

    tile, tail_tile = launch_config(layers)
    nb_grad = -(-n_f // tile) + -(-n_u // tile)
    nb_tail = -(-n_f // tail_tile)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out = {
        "params": empty(n_params), "mu": empty(n_params), "nu": empty(n_params),
        "colloc": empty(n_f, 2),
        "z": empty(n_f, 1) if z is not None else None,
        "dual": empty(n_f, 1) if z is not None else None,
        "metrics": metrics_out if metrics_out is not None else empty(7),
        "grad": empty(n_params) if want_grad else None,
    }
    scratch = {
        "partials": empty(nb_grad, n_params + 1),
        "pstore": empty(nb_grad * (len(layers) - 2) * 4 * max(layers) * tile),
        "tail_partials": empty(nb_tail),
    }
    tensors = {
        "params": params, "mu": mu, "nu": nu, "x_data": x_data, "u_data": u_data,
        "colloc": colloc, "z": z, "dual": dual, "new_colloc": new_colloc,
        "params_out": out["params"], "mu_out": out["mu"], "nu_out": out["nu"],
        "colloc_out": out["colloc"], "z_out": out["z"], "dual_out": out["dual"],
        "metrics": out["metrics"], "grad_out": out["grad"], **scratch,
    }
    bc1, bc2 = bias_corrections(count)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    floats = {
        "lb0": spec.lb[0], "lb1": spec.lb[1], "ub0": spec.ub[0], "ub1": spec.ub[1],
        "lam1": lam1, "lam2": lam2, "rho": rho, "lr": lr,
        "one_minus_b1": 1.0 - B1, "b1": B1, "one_minus_b2": 1.0 - B2, "b2": B2, "eps": EPS,
        "bc1": bc1, "bc2": bc2, "threshold": 1.0 / (rho * n_f),
    }
    ints = {
        "n_u": n_u, "n_f": n_f, "kind": KINDS[kind], "explicit_inner": int(explicit_inner),
        "tile": tile, "tail_tile": tail_tile, "seed": int(seed), "epoch": int(epoch),
        "device": dev.index if dev.index is not None else torch.cuda.current_device(),
    }
    lib = _lib()
    c_dims = (ctypes.c_int * len(layers))(*layers)
    c_ptrs = (ctypes.c_longlong * len(_PTRS))(
        *(tensors[k].data_ptr() if tensors[k] is not None else 0 for k in _PTRS))
    c_floats = (ctypes.c_float * len(_FLOATS))(*(f32(floats[k]) for k in _FLOATS))
    c_ints = (ctypes.c_longlong * len(_INTS))(*(int(ints[k]) for k in _INTS))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pinns_fused_step(c_dims, len(layers) - 1, c_ptrs, c_floats, c_ints, stream)
    if err != 0:
        msg = lib.pinns_fused_step_error_string(err).decode()
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {err} ({msg}); "
                           f"tile={tile} tail_tile={tail_tile} widths={layers}")
    with _launches_lock:
        LAUNCHES += 1
    return out


def unpack_params(flat: torch.Tensor, layers: Sequence[int]) -> Params:
    """JAX-layout layers as views of a flat buffer in ``pack_params`` order."""
    out, off = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        w = flat[off:off + din * dout].view(din, dout)
        off += din * dout
        out.append({"W": w, "b": flat[off:off + dout].view(1, dout)})
        off += dout
    return out


def make_fused_adam_step(problem, learning_rate: float):
    """``step(state, out=None, new_colloc=None) -> (state, metrics)``: the plain step's contract
    (``train.trainer.make_adam_step``) with one CUDA step call per epoch.

    Raises ``NotImplementedError`` for a configuration outside the kernel's
    scope: on the card nothing falls back to the plain step.
    """
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.train.trainer import METRIC_KEYS, TrainState

    exp, spec = problem.exp, problem.spec
    why = fused_step_supported(exp, spec)
    if why:
        raise NotImplementedError(
            f"experiment {exp.name!r} is outside the fused CUDA step's scope ({'; '.join(why)}); "
            "train.trainer.make_step gives it the generic Adam step over the kernel ops"
        )
    lam2_raw = exp.pde.lambda2
    lam2 = float(np.exp(np.float32(lam2_raw))) if exp.pde.lambda2_transform == "exp" else lam2_raw
    cfg = dict(kind=exp.loss.residual_kind, lam1=exp.pde.lambda1, lam2=lam2,
               rho=exp.loss.rho, lr=learning_rate, explicit_inner=exp.loss.explicit_inner)
    u_data = problem.targets["u"].contiguous()

    def step(state, out: Optional[torch.Tensor] = None,
             new_colloc: Optional[torch.Tensor] = None):
        if state.rho is not None:
            raise NotImplementedError(
                "the fused CUDA step bakes loss.rho in and cannot honor a per-run "
                "TrainState.rho (rho-swept ensembles come with slice 4)")
        net = state.params["net"]
        r = fused_adam_step(
            spec, pack_params(net), pack_params(state.opt_state.mu["net"]),
            pack_params(state.opt_state.nu["net"]), state.opt_state.count,
            problem.x_data, u_data, state.colloc,
            state.admm.z if state.admm is not None else None,
            state.admm.dual if state.admm is not None else None,
            seed=state.key, epoch=state.epoch + 1, new_colloc=new_colloc, metrics_out=out,
            **cfg,
        )
        opt = state.opt_state
        new_state = TrainState(
            params=dict(state.params, net=unpack_params(r["params"], spec.layers)),
            opt_state=AdamState(
                count=opt.count + 1,
                mu=dict(opt.mu, net=unpack_params(r["mu"], spec.layers)),
                nu=dict(opt.nu, net=unpack_params(r["nu"], spec.layers)),
            ),
            admm=None if state.admm is None else ADMMState(z=r["z"], dual=r["dual"]),
            colloc=r["colloc"], key=state.key, epoch=state.epoch + 1, rho=state.rho,
        )
        return new_state, {k: r["metrics"][i] for i, k in enumerate(METRIC_KEYS)}

    return step


def loss_and_grad_reference(
    spec: MLPSpec, net: Params, x_data, u_data, colloc, z, dual, *,
    kind: str, lam1: float, lam2: float, rho: float, explicit_inner: bool = False,
):
    """The fused step's loss and gradient by its own algorithm, in plain
    PyTorch: Taylor-2 forward keeping the pre-activation streams, the residual
    and data seeds, and the hand-written reverse mode of the recurrence.

    Returns (loss, data_term, res_term, grads) with grads a list
    [dW_0, db_0, dW_1, ...] shaped like the params.
    """
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    n_u, n_f = x_data.shape[0], colloc.shape[0]
    u, u_x, u_t, u_xx = mlp_taylor_2_reference(spec, net, colloc)
    f = u_t + lam1 * u * u_x - lam2 * u_xx
    if kind == "admm":
        q = f - z + dual / rho
        gf = rho * q + (dual if explicit_inner else 0.0)
        res_term = 0.5 * rho * torch.sum(q * q) + (torch.sum(dual * f) if explicit_inner else 0.0)
    elif kind == "l1_sq_norm":
        s = torch.sum(torch.abs(f))
        gf = 2.0 * s * torch.sign(f) / n_f
        res_term = s * s / n_f
    elif kind in ("mean_sq", "l2_sq_norm"):
        gf = 2.0 * f / n_f
        res_term = torch.sum(f * f) / n_f
    else:
        raise ValueError(f"unknown residual kind {kind!r}")
    seeds = (gf * lam1 * u_x, gf * lam1 * u, gf, -lam2 * gf)
    g_res = taylor2_backward_reference(spec, net, colloc, seeds)
    ud, _, _, _ = mlp_taylor_2_reference(spec, net, x_data)
    d = ud - u_data
    zero = torch.zeros_like(d)
    g_dat = taylor2_backward_reference(spec, net, x_data, (2.0 * d / n_u, zero, zero, zero))
    data_term = torch.sum(d * d) / n_u
    grads = [a + b for a, b in zip(g_res, g_dat)]
    shaped = []
    for i, layer in enumerate(net):
        shaped += [grads[2 * i].reshape(layer["W"].shape), grads[2 * i + 1].reshape(layer["b"].shape)]
    return data_term + res_term, data_term, res_term, shaped
