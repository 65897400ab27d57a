"""Write the Abgrall Burgers grid that the torch port trains on, from the JAX
package's generator on the CPU.

``hwan_l2``, ``abgrall_l1``, ``abgrall_l2`` and ``abgrall_visc`` train on
``abgrall_burgers_shock``. The port reads no .mat file without the reference
tree, so this script stores the grid as the JAX package regenerates it
(``generators.make_abgrall_burgers_grid``: 257 x 257 over [0, pi]^2) in
``tests/fixtures/torch_port/abgrall_burgers_shock.npz``, in the layout of
``burgers_shock.npz``: ``x`` (Nx, 1), ``t`` (Nt, 1), ``usol`` (Nx, Nt),
float32 as ``GridDataset`` holds them, and ``provenance`` 'native'. The
port's dataset loader reads it under the key ``abgrall_burgers_shock``.

Usage (a few seconds on a CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_abgrall_grid.py
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from pinns_tpu.data import generators  # noqa: E402

FIXTURE = "tests/fixtures/torch_port/abgrall_burgers_shock.npz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    d = generators.make_abgrall_burgers_grid()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(
        args.out, x=np.asarray(d["x"], np.float32), t=np.asarray(d["t"], np.float32),
        usol=np.asarray(d["usol"], np.float32), provenance=np.asarray("native"),
    )
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
