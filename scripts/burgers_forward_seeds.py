"""Train burgers_forward at the reduced schedule of the JAX fixture's seed
band (``chip_smoke.py`` phase 15: 3,000 cosine Adam epochs on the generic
step, then one L-BFGS outer epoch) for each of the band's seeds, and print
one JSON line a seed: its u rel-L2, its logged losses and JAX's u rel-L2.

    python scripts/burgers_forward_seeds.py [--tree DIR] [--backward kernel|plain]
                                            [--split-warps N]

The gradient of the Taylor-2 op can be taken in three float32 orders of the
same sums: by K2 (``kernel``, the default); by K2 with dW's sum cut into
other row chunks (``--split-warps N``: ``backward_plan`` sizes the split for
N warps in place of SPLIT_WARPS, ``ops/kernels/taylor2.py``); or by the
plain reverse mode on the card (``--backward plain``:
``taylor2_backward_reference``, cuBLAS products with TF32 off). ``--tree
DIR`` imports ``pinns_tpu_torch`` from DIR in place of this checkout, for
example an older commit unpacked by ``git archive`` into a gitignored
directory, so that its kernels train the same schedule. Needs a CUDA card;
imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (imports no pinns_tpu_torch at import time)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT, help="the checkout whose pinns_tpu_torch trains")
    ap.add_argument("--backward", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--split-warps", type=int, help="backward_plan's SPLIT_WARPS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("burgers_forward_seeds: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from pinns_tpu_torch.ops.kernels import taylor2 as k2

    if args.split_warps is not None:
        k2.SPLIT_WARPS = args.split_warps
    if args.backward == "plain":
        def plain_backward(spec, params, x, cotangents):
            grads = k2.taylor2_backward_reference(spec, params, x, cotangents)
            return torch.cat([g.reshape(-1) for g in grads])

        k2.taylor2_backward = plain_backward
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    sched, seeds, band_rel, band = cs.burgers_forward_band()
    for seed, jax_rel in zip(seeds, band_rel.tolist()):
        trainer, state, summary, logs, launches, plain_calls, wall = \
            cs.reduced_burgers_forward(sched, seed)
        n = int(state.colloc.shape[0])
        plan = (k2.backward_plan(trainer.problem.spec.layers, n).__dict__
                if hasattr(k2, "backward_plan") and args.backward == "kernel" else None)
        print(json.dumps({
            "seed": seed, "rel_l2_u": summary["rel_l2_u"], "jax_rel_l2_u": jax_rel,
            "band": band, "losses": [r["loss"] for r in logs],
            "lbfgs_iters": logs[-1]["lbfgs_iters"], "tree": os.path.abspath(args.tree),
            "backward": args.backward, "split_warps": args.split_warps, "n_colloc": n,
            "plan": plan, "launches": launches, "plain_calls": plain_calls, "wall_s": wall,
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
