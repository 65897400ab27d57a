"""Replay ``burgers_forward`` step by step, JAX against the port, on the CPU
from JAX's own states (ROADMAP P6).

JAX trains from its seed-1234 start (the state of
``tests/fixtures/torch_port/burgers_forward_init.npz``) to ``--to`` epochs,
printing the loss at the state's params and u rel-L2 every ``--log-every``
epochs (the marks ``scripts/p6_port_run.py`` prints for the port). At every
mark from ``--replay-from`` on, ``--replay-steps`` epochs are replayed with
teacher forcing: each epoch starts the port's generic Adam step (the plain
version) and JAX's ``make_adam_step`` from the same JAX state, their
metrics and params are compared, and JAX's result is the next state. A step
leaves the training row's per-step tolerance (``tests/test_torch_train.py``:
metrics rtol 1e-4 / atol 1e-6, params within 2 lr of JAX's with at most 1%
of the entries beyond 1e-6) or it does not; one JSON line a mark says which,
with the worst ratios.

    JAX_PLATFORMS=cpu python scripts/p6_replay.py --to 20000 --replay-from 10000

About 15 minutes on a CPU at 20,000 epochs.
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
import torch  # noqa: E402

from pinns_tpu.config import override  # noqa: E402
from pinns_tpu.experiments import get_preset  # noqa: E402
from pinns_tpu.train import Trainer  # noqa: E402
from pinns_tpu.train.trainer import make_adam_step, make_loss_fn  # noqa: E402
from pinns_tpu_torch.config import override as toverride  # noqa: E402
from pinns_tpu_torch.experiments import get_preset as tget_preset  # noqa: E402
from pinns_tpu_torch.interop import train_state_from_jax, train_state_to_numpy  # noqa: E402
from pinns_tpu_torch.train import trainer as ttrainer  # noqa: E402

SEED = 1234
CPU = torch.device("cpu")


def jax_tree(state) -> dict:
    adam = state.opt_state[0]
    return {"params": jax.device_get(state.params), "count": np.asarray(adam.count),
            "mu": jax.device_get(adam.mu), "nu": jax.device_get(adam.nu),
            "colloc": np.asarray(state.colloc), "epoch": np.asarray(state.epoch), "key": SEED}


def flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel() for layer in params["net"]
                           for a in (layer["W"], layer["b"])])


def replay(jstep, tstep, lr, jstate, steps: int) -> dict:
    """Teacher-forced steps from ``jstate``: the worst metric and param
    ratios against the per-step tolerance, and the first step beyond it."""
    worst_metric, worst_param, worst_frac, first_bad = 0.0, 0.0, 0.0, None
    for i in range(steps):
        tree = jax_tree(jstate)
        count = int(tree["count"])
        tnext, tm = tstep(train_state_from_jax(tree, CPU, key=SEED))
        jstate, jm = jstep(jstate)
        metric = max(abs(float(tm[k]) - float(jm[k])) / (1e-6 + 1e-4 * abs(float(jm[k])))
                     for k in jm if k in tm)
        diff = np.abs(flat(train_state_to_numpy(tnext)["params"])
                      - flat(jax.device_get(jstate.params)))
        param = float(diff.max()) / (2.0 * lr(count))
        frac = float(np.mean(diff > 1e-6))
        worst_metric, worst_param = max(worst_metric, metric), max(worst_param, param)
        worst_frac = max(worst_frac, frac)
        if first_bad is None and (metric > 1.0 or param > 1.0 + 1e-3 or frac > 0.01):
            first_bad = {"step": i, "epoch": count, "metric_ratio": metric,
                         "param_ratio": param, "frac_beyond_1e-6": frac}
    return {"worst_metric_ratio": worst_metric, "worst_param_ratio": worst_param,
            "worst_frac_beyond_1e-6": worst_frac, "first_beyond_tolerance": first_bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--to", type=int, default=20_000)
    ap.add_argument("--log-every", type=int, default=1_000)
    ap.add_argument("--replay-from", type=int, default=10_000)
    ap.add_argument("--replay-steps", type=int, default=100)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    exp = override(get_preset("burgers_forward"), {"train.seed": SEED, "train.log_every": 0})
    jt = Trainer(exp)
    tt = ttrainer.Trainer(toverride(tget_preset("burgers_forward"), {"train.seed": SEED}),
                          device="cpu")
    assert np.array_equal(tt.problem.x_data.numpy(), np.asarray(jt.problem.x_data))
    jstep = jax.jit(make_adam_step(jt.problem, jt.optimizer))
    tstep = ttrainer.make_step(tt.problem, tt.learning_rate)
    loss_fn = jax.jit(lambda p, c, a: make_loss_fn(jt.problem)(p, c, a)[0])
    jstate = jt.init_state()
    t0 = time.time()
    for mark in range(args.log_every, args.to + 1, args.log_every):
        jstate, summary = jt.train(jstate, epochs=mark)
        row = {"side": "jax", "device": "cpu", "epoch": int(jstate.epoch),
               "loss": float(loss_fn(jstate.params, jstate.colloc, jstate.admm)),
               "rel_l2_u": summary["rel_l2_u"]}
        if mark >= args.replay_from:
            row["replay"] = dict(replay(jstep, tstep, tt.learning_rate, jstate,
                                        args.replay_steps), steps=args.replay_steps)
        row["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
