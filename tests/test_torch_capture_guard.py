"""Every preset's L-BFGS evaluation is ready to be captured into the body of
K10's WHILE node (``ops/kernels/lbfgs.py::AutogradLBFGS``), held on the CPU:
``AutogradLBFGS._evaluate`` over the trainer's loss of each shipped preset,
and of ``burgers_forward`` with each knob that changes the loss (Fourier
features, shock paths, the causal and gradient weightings, the entropy
penalty, the mixed stream policy, microbatches), runs with every Tensor
method that reads a value to the host made to raise
(``torch_port_util.no_host_reads``) and writes a finite loss and gradient
into the solve's buffers. Nets 2 -> 8 -> 8 -> out, 64 collocation points
(256 for burgers_scale's 128 microbatches).
"""

import pytest
import torch

from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import PRESETS, get_preset
from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
from pinns_tpu_torch.opt.lbfgs import ravel_tree
from pinns_tpu_torch.train import trainer as tr
from torch_port_util import no_host_reads

KNOBS = {"fourier": {"model.n_fourier": 4}, "paths": {"model.n_paths": 2},
         "causal": {"loss.causal_eps": 1.0}, "grad_weight": {"loss.grad_weight_kappa": 1.0},
         "entropy": {"loss.entropy_weight": 0.1},
         "mixed": {"model.compute_dtype": "bfloat16", "model.keep_streams": ("xx",)},
         "microbatch": {"sampling.microbatch": 2}}
CASES = [(name, "preset") for name in sorted(PRESETS)] + [("burgers_forward", k) for k in KNOBS]


@pytest.mark.parametrize("name,knob", CASES)
def test_evaluation_reads_nothing_to_the_host(name, knob):
    exp = get_preset(name)
    w = exp.model.layers
    upd = {"sampling.n_f": 256 if exp.sampling.microbatch > 1 else 64, "data.n_u": 32,
           "optimizer.kind": "hybrid", "model.layers": (w[0], 8, 8, w[-1]),
           **KNOBS.get(knob, {})}
    trainer = tr.Trainer(override(exp, upd), device="cpu")
    state = trainer.init_state()
    loss_fn = tr.make_loss_fn(trainer.problem)
    x0, unravel = ravel_tree(state.params)
    fun = lambda x: loss_fn(unravel(x), state.colloc, state.admm, state.rho)[0]  # noqa: E731
    solver = k_lbfgs.AutogradLBFGS()
    solver.bufs = b = k_lbfgs.Buffers.alloc(x0.numel(), 50, "cpu")
    k_lbfgs.reset(b, x0.detach().contiguous(), max_iters=5)
    with no_host_reads():
        solver._evaluate(fun)
    assert torch.isfinite(b.sf[k_lbfgs.F_PHI_T]) and torch.isfinite(b.vec[k_lbfgs.GT]).all()
    assert float(b.vec[k_lbfgs.GT].abs().max()) > 0.0
