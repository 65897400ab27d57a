"""Where the time of a served ensemble `predict` goes on the card:
torch.profiler over served predicts of two calibrated ensemble artifacts
built from the committed fixture (tests/fixtures/torch_port/ensemble_serve.npz),
with the calibrated bands.

    python scripts/profile_served_ensemble.py [--reps 20] [--members 8]
        [--out build/profile_served_ensemble.json]

- ``burgers``: the fixture's four burgers_forward 8x20 members and perturbed
  copies up to ``--members`` (each leaf times 1 + 0.01 N(0, 1), numpy seed
  350), served at the fixture's 25,600 points (bucket 32,768);
- ``euler``: its three euler_weak_fast trunks with two shock paths and
  perturbed copies up to ``--members``, at the 47,100 abgrall_eulers grid
  points (bucket 65,536).

Both carry the fixture's 'dx' calibration rows, so each predict also serves
the front feature {name}_dx (one K7a call a member). Per predict (a unit) it
reports what ``scripts/profile_train_step.py::profile_chunk`` does: wall time
(host clock, ending in a synchronize), device time by kernel, the sum over
K7a's kernels (namespace k7), the idle share 1 - device / wall, the top host
operations and the peak device memory; and the launches of K8s (a), K7a and
K8s (c) a predict. Needs one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "ensemble_serve.npz")


def artifact(fx: dict, kind: str, members: int, path: str) -> str:
    """An ensemble artifact of the fixture's ``kind`` members, perturbed
    copies of member 0 added up to ``members``, with its 'dx' calibration."""
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops.kernels.taylor2 import nets_from_flat
    from pinns_tpu_torch.serve import export_ensemble

    paths = {}
    if f"{kind}_n_paths" in fx:
        paths = {"n_paths": int(fx[f"{kind}_n_paths"]),
                 "path_degree": int(fx[f"{kind}_path_degree"]),
                 "path_sharpness": float(fx[f"{kind}_path_sharpness"])}
    spec = MLPSpec(layers=tuple(int(v) for v in fx[f"{kind}_layers"]),
                   lb=tuple(fx[f"{kind}_lb"]), ub=tuple(fx[f"{kind}_ub"]), **paths)
    flat = np.asarray(fx[f"{kind}_params"], np.float32)
    rng = np.random.default_rng(350)
    extra = [flat[0] * (1.0 + 0.01 * rng.standard_normal(flat.shape[1]))
             for _ in range(members - flat.shape[0])]
    flat = np.concatenate([flat, np.asarray(extra, np.float32).reshape(-1, flat.shape[1])])
    nets = nets_from_flat(spec, torch.from_numpy(np.ascontiguousarray(flat[:members])))
    lam = lambda key: [float(fx[f"{kind}_{key}"][min(i, len(fx[f"{kind}_{key}"]) - 1)])  # noqa: E731
                       for i in range(members)]
    cal = json.loads(str(fx[f"{kind}_calibration"]))["dx"]
    return export_ensemble(spec, nets, path, lam("lambda1"), lam("lambda2"),
                           experiment=str(fx[f"{kind}_preset"]),
                           pde="euler" if paths else "burgers", calibration=cal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--out", default="build/profile_served_ensemble.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_served_ensemble: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pinns_tpu_torch.data.datasets import load_euler_mat
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.serve import ServedModel
    from scripts.profile_train_step import profile_chunk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    with np.load(FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    points = {"burgers": fx["burgers_x"], "euler": load_euler_mat("abgrall_eulers").X_star}
    report = {"card": card, "members": args.members, "reps": args.reps}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, x in points.items():
            served = ServedModel(artifact(fx, kind, args.members, os.path.join(tmp, kind)),
                                 device="cuda")

            def run(state, n):
                for _ in range(n):
                    served.add_bands(served.predict(x, pad_to_bucket=True))
                return state, {"lbfgs_iters": torch.zeros(1)}

            before = (k_taylor2.MEMBER_LAUNCHES, k_taylor1.LAUNCHES, k_ens.LAUNCHES)
            row = profile_chunk(run, None, args.reps)
            after = (k_taylor2.MEMBER_LAUNCHES, k_taylor1.LAUNCHES, k_ens.LAUNCHES)
            calls = args.reps + 5  # the warm-up's five predicts as well
            row.update(n=int(x.shape[0]), bucket=served.bucket_size(x.shape[0]), unit="predict",
                       launches_per_predict={k: (a - b) / calls for k, a, b in zip(
                           ("taylor2_members", "taylor1", "member_stats"), after, before)})
            report[kind] = row
            print(json.dumps({"ensemble": kind, "card": card,
                              **{k: row[k] for k in ("n", "bucket", "wall_us_per_unit",
                                                     "device_us_per_unit", "idle_share",
                                                     "k7_us_per_unit", "launches_per_predict",
                                                     "peak_device_bytes")}}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
