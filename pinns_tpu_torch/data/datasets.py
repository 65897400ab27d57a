"""Dense space-time solution grids and the supervised training sets (port of
``pinns_tpu/data/datasets.py``).

``GridDataset`` and the training-set builders are the JAX package's, in numpy
with the same seeded draws, so both packages pick the same N_u points from one
seed. A dataset key or a path is read, in this order:

1. an explicit path: a ``.mat`` with {x, t, usol} or a grid ``.npz`` with the
   same keys (plus ``provenance``), e.g. one written by
   ``scripts/make_torch_train_fixture.py``;
2. for a dataset key, the reference ``.mat`` under ``$PINNS_TPU_DATA_ROOT``
   (the JAX package's variable) when that is set and the file exists;
3. for a Burgers key, the grid committed beside the port's test fixtures
   (``tests/fixtures/torch_port/<key>.npz``: ``twosin_burgers_shock``,
   ``burgers_shock`` and ``abgrall_burgers_shock``, which the JAX package
   generated once on the CPU; ``scripts/make_torch_abgrall_grid.py`` writes
   the last), so that every parity fixture keeps the data it was made on;
4. else the key's native generation, provenance 'native', as the JAX
   package's ``_generate_fallback`` does when the reference ``.mat`` is
   absent (``data.generators``): ``burgers_shock`` by Cole-Hopf, the TwoSin
   and Abgrall Burgers grids by the FV solver (K12 on the card, the plain
   version on the CPU: ``device``, the card unless the caller asks for the
   CPU), and ``abgrall_eulers`` by the exact Riemann solution (numpy
   float64; it has no committed grid).

A path that does not exist and is no known key raises ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

BURGERS_DATASETS = {
    "burgers_shock": "Burgers/Data/burgers_shock.mat",
    "abgrall_burgers_shock": "Burgers/Data/Abgrall_burgers_shock.mat",
    "twosin_burgers_shock": "Burgers/Data/TwoSin_burgers_shock.mat",
}
EULER_DATASETS = {
    "abgrall_eulers": "Eulers/Data/Abgrall_eulers.mat",
}
GRID_DIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "torch_port"


@dataclasses.dataclass
class GridDataset:
    """A dense (t, x) solution grid plus flattened evaluation set.

    fields maps field name -> (Nt, Nx) array ('u' for Burgers). X_star is
    (Nt*Nx, 2) with columns (x, t); star maps field name -> (Nt*Nx, 1).
    provenance is 'stored' (a reference .mat) or 'native' (a grid the JAX
    package regenerated), as in the JAX package.
    """

    x: np.ndarray  # (Nx, 1)
    t: np.ndarray  # (Nt, 1)
    fields: Dict[str, np.ndarray]  # each (Nt, Nx)
    name: str = "dataset"
    provenance: str = "unknown"

    def __post_init__(self):
        self.x = np.asarray(self.x, np.float32).reshape(-1, 1)
        self.t = np.asarray(self.t, np.float32).reshape(-1, 1)
        self.fields = {k: np.asarray(v, np.float32) for k, v in self.fields.items()}
        xg, tg = np.meshgrid(self.x.ravel(), self.t.ravel())
        self.X_grid, self.T_grid = xg, tg
        self.X_star = np.hstack([xg.reshape(-1, 1), tg.reshape(-1, 1)]).astype(np.float32)
        self.star = {k: v.reshape(-1, 1) for k, v in self.fields.items()}
        self.lb = self.X_star.min(axis=0)
        self.ub = self.X_star.max(axis=0)

    @property
    def field_names(self) -> Tuple[str, ...]:
        return tuple(self.fields.keys())

    @property
    def n_points(self) -> int:
        return self.X_star.shape[0]


def _read_grid(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            out = {k: z[k] for k in z.files}
        out["_provenance"] = str(out.pop("provenance", "unknown"))
        return out
    import scipy.io

    return dict(scipy.io.loadmat(path), _provenance="stored")


def resolve_grid_path(name_or_path: str) -> Optional[str]:
    """Where the grid of a dataset key (or path) is read from, or None for a
    key that is generated natively; see the module docstring for the order."""
    if name_or_path not in BURGERS_DATASETS:
        if os.path.exists(name_or_path):
            return name_or_path
        raise FileNotFoundError(
            f"dataset {name_or_path!r} is neither a known key "
            f"({sorted(BURGERS_DATASETS)}) nor an existing .mat/.npz file"
        )
    root = os.environ.get("PINNS_TPU_DATA_ROOT")
    if root:
        mat = os.path.join(root, BURGERS_DATASETS[name_or_path])
        if os.path.exists(mat):
            return mat
    grid = GRID_DIR / f"{name_or_path}.npz"
    if grid.exists():
        return str(grid)
    return None


def generate_fallback(name: str, device="cuda") -> Optional[dict]:
    """The native grid of a known dataset key (the JAX package's
    ``_generate_fallback``), or None for any other name. The FV grids run on
    ``device``."""
    from pinns_tpu_torch.data import generators as g

    if name == "burgers_shock":
        return g.make_burgers_shock_grid(nx=256, nt=100)
    if name == "twosin_burgers_shock":
        return g.make_twosin_grid(device=device)
    if name == "abgrall_burgers_shock":
        return g.make_abgrall_burgers_grid(device=device)
    if name == "abgrall_eulers":
        return g.make_abgrall_eulers_grid()
    return None


def load_burgers_mat(name_or_path: str = "twosin_burgers_shock", device="cuda") -> GridDataset:
    """Load a Burgers {x, t, usol} grid from a dataset key or a path; a key
    with no stored or committed grid is generated natively on ``device``
    (see the module docstring)."""
    path = resolve_grid_path(name_or_path)
    if path is None:
        d = dict(generate_fallback(name_or_path, device), _provenance="native")
    else:
        d = _read_grid(path)
    name = name_or_path if name_or_path in BURGERS_DATASETS else Path(path).stem
    return GridDataset(
        x=d["x"],
        t=d["t"],
        fields={"u": np.real(d["usol"]).T},  # stored (Nx, Nt) -> (Nt, Nx)
        name=name,
        provenance=d["_provenance"],
    )


def _euler_grid(name_or_path: str) -> dict:
    """The Euler grid's arrays: an explicit .mat/.npz path, the reference
    .mat under ``$PINNS_TPU_DATA_ROOT``, else the native exact grid."""
    if name_or_path not in EULER_DATASETS:
        if os.path.exists(name_or_path):
            return _read_grid(name_or_path)
        raise FileNotFoundError(
            f"dataset {name_or_path!r} is neither a known key "
            f"({sorted(EULER_DATASETS)}) nor an existing .mat/.npz file"
        )
    root = os.environ.get("PINNS_TPU_DATA_ROOT")
    if root:
        mat = os.path.join(root, EULER_DATASETS[name_or_path])
        if os.path.exists(mat):
            return _read_grid(mat)
    return dict(generate_fallback(name_or_path), _provenance="native")


def load_euler_mat(name_or_path: str = "abgrall_eulers") -> GridDataset:
    """Load the Euler {x, t, rhosol, usol, Enersol} grid from a dataset key or
    a path; the key builds the exact grid natively (numpy) when no reference
    .mat is found (see the module docstring)."""
    d = _euler_grid(name_or_path)
    name = name_or_path if name_or_path in EULER_DATASETS else Path(name_or_path).stem
    return GridDataset(
        x=d["x"],
        t=d["t"],
        fields={  # stored (Nx, Nt) -> (Nt, Nx)
            "rho": np.real(d["rhosol"]).T,
            "u": np.real(d["usol"]).T,
            "E": np.real(d["Enersol"]).T,
        },
        name=name,
        provenance=d["_provenance"],
    )


def ic_bc_candidates(ds: GridDataset) -> np.ndarray:
    """The full IC row + boundary column candidate stack (Nx + 2 Nt, 2)."""
    xg, tg = ds.X_grid, ds.T_grid
    ic = np.hstack([xg[0:1, :].T, tg[0:1, :].T])
    left = np.hstack([xg[:, 0:1], tg[:, 0:1]])
    right = np.hstack([xg[:, -1:], tg[:, -1:]])
    return np.vstack([ic, left, right]).astype(np.float32)


def _add_noise(targets, noise, rng):
    if noise > 0.0:
        for k in targets:
            targets[k] = targets[k] + noise * targets[k].std() * rng.standard_normal(
                targets[k].shape
            ).astype(np.float32)
    return targets


def build_ic_bc_training_set(
    ds: GridDataset,
    n_u: int,
    seed: int = 1234,
    rng: Optional[np.random.Generator] = None,
    noise: float = 0.0,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """IC row + boundary columns, subsampled to n_u points without replacement
    (the same ``np.random.default_rng(seed).choice`` draw as the JAX package).

    Returns (X_data:(n_u,2), targets: field -> (n_u,1)).
    """
    candidates = ic_bc_candidates(ds)
    targets_full = {
        k: np.vstack([grid[0:1, :].T, grid[:, 0:1], grid[:, -1:]]).astype(np.float32)
        for k, grid in ds.fields.items()
    }
    if rng is None:
        rng = np.random.default_rng(seed)
    idx = rng.choice(candidates.shape[0], size=n_u, replace=False)
    targets = {k: v[idx] for k, v in targets_full.items()}
    return candidates[idx], _add_noise(targets, noise, rng)


def interior_training_set(
    ds: GridDataset,
    n_u: int,
    seed: int = 1234,
    rng: Optional[np.random.Generator] = None,
    noise: float = 0.0,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Random interior (full-grid) sample of n_u points, optionally noisy."""
    if rng is None:
        rng = np.random.default_rng(seed)
    idx = rng.choice(ds.n_points, size=n_u, replace=False)
    targets = {k: v[idx] for k, v in ds.star.items()}
    return ds.X_star[idx], _add_noise(targets, noise, rng)
