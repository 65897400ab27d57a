"""The float64 L-BFGS polish of a trained checkpoint (port of
``pinns_tpu/cli.py::_cmd_polish_x64``, ``:486-557``).

The JAX package trains in float32 and then polishes the final state on the
CPU in float64, because the TPU has no float64: the same loss
(``make_loss_fn(problem)(params, colloc, admm)`` at the checkpoint's batch
and ADMM state, the rho of the configuration: JAX passes none, so the
loss takes ``loss.rho``), minimized by L-BFGS with SciPy's stops at
``ftol=1e-15`` and ``gtol=1e-12``, the history of
``optimizer.lbfgs.history``, the line search's default budget. That is how
the Burgers presets reach their quality of record.

The port runs the same solve on the device of the problem, in float64:
- on a CUDA device, K10's float64 mode (``ops.kernels.lbfgs.AutogradLBFGS``:
  the reset, control and direction kernels on double state) around
  autograd through the loss, whose forward and backward are K1, K2 and K5's
  float64 modes (``ops.kernels.taylor2``, ``ops.kernels.mlp_forward``),
  the evaluation captured with the control and direction kernels into the
  solve's WHILE-node graph: the whole polish is one launch of it and one
  read of the device; nothing runs the host loop;
- on the CPU, the host loop ``opt.lbfgs.lbfgs_minimize_pytree`` over the
  plain loss, which follows JAX's branches in float64.

``python -m pinns_tpu_torch polish`` (``cli.py``) loads the checkpoint into
float64 (``Trainer.load_checkpoint`` on a float64 trainer), calls
:func:`polish` and writes ``<checkpoint>.polished.ckpt``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pinns_tpu_torch.device import pin_numerics
from pinns_tpu_torch.opt.lbfgs import LBFGSResult, lbfgs_minimize_pytree, ravel_tree
from pinns_tpu_torch.train.trainer import Problem, TrainState, make_loss_fn

FTOL = 1e-15  # JAX's polish (pinns_tpu/cli.py:544-545)
GTOL = 1e-12


def polish(problem: Problem, state: TrainState,
           max_iters: int) -> Tuple[TrainState, LBFGSResult]:
    """The float64 L-BFGS polish of ``state`` (float64 params, batch and
    ADMM state on ``problem``'s device, as a float64 trainer loads them):
    the state with the polished params, and the solve's result."""
    if problem.spec.dtype != torch.float64:
        raise ValueError(f"polish runs in float64 (model.dtype='float64'), got "
                         f"{problem.spec.dtype}")
    pin_numerics()
    loss_fn = make_loss_fn(problem)
    colloc, admm = state.colloc, state.admm

    def fun(params):
        return loss_fn(params, colloc, admm)[0]

    opts = dict(max_iters=int(max_iters), history=problem.exp.optimizer.lbfgs.history,
                ftol=FTOL, gtol=GTOL)
    if problem.device.type == "cuda":
        from pinns_tpu_torch.ops.kernels.lbfgs import AutogradLBFGS

        x0, unravel = ravel_tree(state.params)
        res = AutogradLBFGS().minimize(lambda x: fun(unravel(x)), x0.detach(), **opts)
        params = unravel(res.x)
    else:
        params, res = lbfgs_minimize_pytree(fun, state.params, **opts)
    return state._replace(params=params), res
