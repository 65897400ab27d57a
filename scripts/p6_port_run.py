"""Train the port's ``burgers_forward`` from JAX's seed-1234 start, with a
log of loss and u rel-L2 a mark (ROADMAP P6).

The start is ``tests/fixtures/torch_port/burgers_forward_init.npz``
(``scripts/make_torch_p6_fixture.py``): JAX's initial weights and its
anchored batch. The port then runs the preset's schedule through
``Trainer.train`` (on the card: K9's graphed generic chunks, then K10's
L-BFGS outer epochs) and prints one JSON line a mark (every ``--log-every``
epochs, the switch to L-BFGS and the end): the epoch, the loss at the
state's params on its batch, u rel-L2 on the grid and the card's name and
power limit. The JAX side of the same marks comes from
``make_torch_p6_fixture.py --epochs N`` on the CPU.

    python scripts/p6_port_run.py [--device cuda] [--epochs 200010] [--log-every 10000]

The full schedule takes some 3 minutes on an H100.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "burgers_forward_init.npz")


def card(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def jax_start(trainer, path: str = FIXTURE):
    """The port's TrainState at JAX's start: its weights and batch, Adam's
    moments at zero, epoch 0."""
    import numpy as np
    import torch

    from pinns_tpu_torch.interop import load_params_npz, params_from_jax
    from pinns_tpu_torch.opt.adam import adam_init
    from pinns_tpu_torch.train.trainer import TrainState

    loaded = load_params_npz(path)
    with np.load(path, allow_pickle=False) as z:
        colloc, seed = z["colloc"], int(z["seed"])
    dtype, device = trainer.problem.spec.dtype, trainer.device
    params = {"net": params_from_jax(loaded["params"], device),
              "coeffs": {k: torch.full((1,), float(loaded[k]), dtype=dtype, device=device)
                         for k in ("lambda1", "lambda2")}}
    return TrainState(params=params, opt_state=adam_init(params), admm=None,
                      colloc=torch.as_tensor(colloc, dtype=dtype).to(device), key=seed, epoch=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=None, help="stop here (default: the schedule)")
    ap.add_argument("--log-every", type=int, default=10_000)
    args = ap.parse_args(argv)
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.trainer import Trainer, make_loss_fn

    exp = override(get_preset("burgers_forward"), {"train.log_every": 0})
    trainer = Trainer(exp, device=args.device)
    trainer.logger.console = False
    state = jax_start(trainer)
    total = exp.train.epochs if args.epochs is None else args.epochs
    marks = sorted({*range(args.log_every, total + 1, args.log_every), total,
                    *([exp.optimizer.switch_epoch] if exp.optimizer.switch_epoch < total else [])})
    loss_fn = make_loss_fn(trainer.problem)
    name = card(args.device)
    t0 = time.time()
    for mark in marks:
        state, summary = trainer.train(state, epochs=mark)
        loss = float(loss_fn(state.params, state.colloc, state.admm)[0])
        print(json.dumps({"side": "port", "device": args.device, "card": name,
                          "epoch": int(state.epoch), "loss": loss,
                          "rel_l2_u": summary["rel_l2_u"],
                          "wall_s": round(time.time() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
