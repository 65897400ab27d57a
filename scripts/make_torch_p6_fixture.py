"""Write JAX's seed-1234 start of ``burgers_forward`` for the port, and
optionally train JAX from it on the CPU with a log of loss and u rel-L2.

The port's trainer draws its initial weights with ``torch.Generator`` and
JAX's with ``jax.random``, so the port's seeds and JAX's share no start.
This script stores JAX's start so that the port can train from it
(``scripts/p6_port_run.py``):

``tests/fixtures/torch_port/burgers_forward_init.npz``
    the params file format of ``pinns_tpu_torch.interop`` (``layers``,
    ``lb``, ``ub``, ``W_i`` / ``b_i``, lambda1 / lambda2) of JAX's
    ``Trainer.init_state()`` for ``burgers_forward`` at seed 1234, and
    ``colloc``: its anchored batch (``fixed_lhs_anchored``: 10,000 Latin
    hypercube points, then the 456 IC/BC candidates), float32 (10,456, 2).

With ``--epochs N`` it then trains JAX's ``burgers_forward`` from that state
to epoch N on the CPU and prints one JSON line a mark (every
``--log-every`` epochs): the epoch, the loss at the state's params on its
batch, and u rel-L2 on the grid, the same definitions the port's script
prints.

    JAX_PLATFORMS=cpu python scripts/make_torch_p6_fixture.py [--epochs 50000]

The fixture takes seconds; 50,000 epochs take about 15 minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.trainer import make_loss_fn  # noqa: E402
from pinns_tpu_torch.interop import save_params_npz  # noqa: E402
from pinns_tpu_torch.models.mlp import MLPSpec  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "burgers_forward_init.npz")
SEED = 1234


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURE)
    ap.add_argument("--epochs", type=int, default=0, help="train JAX to this epoch (0: no)")
    ap.add_argument("--log-every", type=int, default=10_000)
    args = ap.parse_args(argv)
    exp = override(get_preset("burgers_forward"), {"train.seed": SEED, "train.log_every": 0})
    trainer = Trainer(exp)
    state = trainer.init_state()
    net = [{"W": np.asarray(p["W"]), "b": np.asarray(p["b"])} for p in state.params["net"]]
    spec = trainer.problem.spec
    save_params_npz(args.out, MLPSpec(layers=tuple(spec.layers), lb=tuple(map(float, spec.lb)),
                                      ub=tuple(map(float, spec.ub))),
                    net, exp.pde.lambda1, exp.pde.lambda2, experiment=exp.name,
                    colloc=np.asarray(state.colloc, np.float32), seed=np.int64(SEED))
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", flush=True)
    if args.epochs <= 0:
        return 0
    loss_fn = jax.jit(lambda p, c, a: make_loss_fn(trainer.problem)(p, c, a)[0])
    t0 = time.time()
    for mark in range(args.log_every, args.epochs + 1, args.log_every):
        state, summary = trainer.train(state, epochs=mark)
        print(json.dumps({"side": "jax", "device": "cpu", "epoch": int(state.epoch),
                          "loss": float(loss_fn(state.params, state.colloc, state.admm)),
                          "rel_l2_u": summary["rel_l2_u"],
                          "wall_s": round(time.time() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
