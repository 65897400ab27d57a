"""Static figures: solution heatmap + time-slice comparisons vs exact (port
of ``pinns_tpu/viz/plots.py``, numpy and matplotlib only).

Layout parity with the reference's ``plot_results`` / ``plot_data.py`` family
(``Abgrall_ADMM.py:321-398`` and the ~15 copies under ``figures/**``): a
space-time heatmap of the predicted field with the training points overlaid,
plus three t-slice panels comparing prediction against the exact solution at
the 25/50/75% times. One figure per field (Burgers: u; Euler: rho, u, E).

Difference by design: the reference round-trips through CSV and re-grids with
``scipy.interpolate.griddata(cubic)``; our snapshots are evaluated ON the
exact grid, so plotting is a reshape — no interpolation error, no SciPy
dependency in the hot path.

matplotlib is imported inside the functions, so importing this module (and
the CLI) never needs it; a machine without it fails at the call, naming it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend; an ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed here; "
                          "run plot / animate where it is") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _grid_pred(ds, values: np.ndarray) -> np.ndarray:
    """(Nt*Nx, 1) flattened prediction -> (Nt, Nx) grid."""
    nt, nx = ds.fields[next(iter(ds.fields))].shape
    return np.asarray(values).reshape(nt, nx)


def plot_solution(
    ds,
    preds: Dict[str, np.ndarray],
    x_data: Optional[np.ndarray] = None,
    out_path: str = "solution.png",
    title: str = "",
):
    """Render heatmap + slices for every field; saves one PNG (stacked rows)."""
    plt = _pyplot()

    fields = [k for k in ds.field_names if k in preds]
    nt = ds.t.shape[0]
    slice_idx = [nt // 4, nt // 2, (3 * nt) // 4]

    fig, axes = plt.subplots(
        len(fields), 4, figsize=(16, 4 * len(fields)), squeeze=False,
        gridspec_kw={"width_ratios": [2, 1, 1, 1]},
    )
    for row, name in enumerate(fields):
        exact = ds.fields[name]
        pred = _grid_pred(ds, preds[name])
        ax = axes[row][0]
        h = ax.imshow(
            pred.T,
            interpolation="nearest",
            cmap="rainbow",
            extent=[ds.t.min(), ds.t.max(), ds.x.min(), ds.x.max()],
            origin="lower",
            aspect="auto",
        )
        fig.colorbar(h, ax=ax, fraction=0.046)
        if x_data is not None:
            ax.plot(
                x_data[:, 1], x_data[:, 0], "kx", markersize=2, clip_on=False,
                label=f"Data ({x_data.shape[0]} points)",
            )
            ax.legend(loc="upper right", fontsize=8)
        ax.set_xlabel("$t$")
        ax.set_ylabel("$x$")
        ax.set_title(f"${name}(t,x)$" + (f" — {title}" if title else ""))

        for col, ti in enumerate(slice_idx, start=1):
            ax = axes[row][col]
            ax.plot(ds.x.ravel(), exact[ti], "b-", linewidth=2, label="Exact")
            ax.plot(ds.x.ravel(), pred[ti], "r--", linewidth=2, label="Prediction")
            ax.set_xlabel("$x$")
            ax.set_ylabel(f"${name}(t,x)$")
            ax.set_title(f"$t = {float(ds.t[ti, 0]):.2f}$")
            if col == 2:
                ax.legend(loc="best", fontsize=8)

    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_uncertainty(
    ds,
    uq: Dict[str, Dict[str, np.ndarray]],
    out_path: str = "uncertainty.png",
    title: str = "",
    band_k: float = 2.0,
    calibration: Optional[dict] = None,
):
    """Render deep-ensemble uncertainty (`ensemble_predict` output): per field
    a predictive-std heatmap plus t-slices of the ensemble mean with a
    ±band_k·σ band against the exact solution. Same panel layout as
    `plot_solution`. Deep ensembles are measured ~8× overconfident on this
    suite (PARITY §4n) — pass the split-conformal ``k_conf95`` from
    `uq_calibration` as ``band_k`` to draw honest 95% bands, or pass the
    whole `uq_calibration` dict as ``calibration`` to draw the Mondrian
    std-binned bands (per-point factors; near-95% coverage even at fronts).
    """
    plt = _pyplot()

    fields = [k for k in ds.field_names if k in uq]
    nt = ds.t.shape[0]
    slice_idx = [nt // 4, nt // 2, (3 * nt) // 4]

    fig, axes = plt.subplots(
        len(fields), 4, figsize=(16, 4 * len(fields)), squeeze=False,
        gridspec_kw={"width_ratios": [2, 1, 1, 1]},
    )
    for row, name in enumerate(fields):
        exact = ds.fields[name]
        mean = _grid_pred(ds, uq[name]["mean"])
        std = _grid_pred(ds, uq[name]["std"])
        k_grid, band_label = None, f"$\\pm {band_k:g}\\sigma$"
        cal_row = (calibration or {}).get(name)
        if cal_row:
            from pinns_tpu_torch.parallel.ensemble import mond_band_factors

            # front-aware ('dx') calibrations bin each point by its own
            # predicted |d(field)/dx| — available when the uq dict came
            # from ensemble_predict(want_dx=True); without it
            # mond_band_factors falls back to the global k_conf95 rather
            # than binning std against the wrong edges
            dx = uq[name].get("dx")
            feat = _grid_pred(ds, dx) if (
                dx is not None
                and cal_row.get("mond_feature", "std") == "dx"
            ) else None
            k_grid = mond_band_factors(
                cal_row, std, default=band_k, feature=feat
            )
            # label what is actually drawn: per-point Mondrian factors
            # only when the row carries them AND the binning feature is
            # available, else the constant k_conf95
            binned = bool(cal_row.get("mond_k")) and (
                cal_row.get("mond_feature", "std") != "dx" or feat is not None
            )
            band_label = (
                "$\\pm k_{95}(\\sigma)\\,\\sigma$" if binned
                else f"$\\pm {float(cal_row.get('k_conf95', band_k)):.1f}"
                "\\sigma$"
            )
        ax = axes[row][0]
        h = ax.imshow(
            std.T,
            interpolation="nearest",
            cmap="viridis",
            extent=[ds.t.min(), ds.t.max(), ds.x.min(), ds.x.max()],
            origin="lower",
            aspect="auto",
        )
        fig.colorbar(h, ax=ax, fraction=0.046)
        ax.set_xlabel("$t$")
        ax.set_ylabel("$x$")
        n_members = uq[name]["members"].shape[0]
        ax.set_title(
            f"$\\sigma[{name}](t,x)$, {n_members} members"
            + (f" — {title}" if title else "")
        )

        for col, ti in enumerate(slice_idx, start=1):
            ax = axes[row][col]
            ax.plot(ds.x.ravel(), exact[ti], "b-", linewidth=2, label="Exact")
            ax.plot(
                ds.x.ravel(), mean[ti], "r--", linewidth=2, label="Ens. mean"
            )
            half = (band_k if k_grid is None else k_grid[ti]) * std[ti]
            ax.fill_between(
                ds.x.ravel(),
                mean[ti] - half,
                mean[ti] + half,
                color="r",
                alpha=0.2,
                label=band_label,
            )
            ax.set_xlabel("$x$")
            ax.set_ylabel(f"${name}(t,x)$")
            ax.set_title(f"$t = {float(ds.t[ti, 0]):.2f}$")
            if col == 2:
                ax.legend(loc="best", fontsize=8)

    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def load_snapshots(csv_path: str):
    """Read a snapshot stream CSV -> (header, array, epochs present)."""
    import csv as csv_mod

    with open(csv_path) as fh:
        reader = csv_mod.reader(fh)
        header = next(reader)
        data = np.array([[float(v) for v in row] for row in reader])
    epochs = np.unique(data[:, header.index("epoch")]).astype(int)
    return header, data, epochs


def plot_from_snapshots(
    ds, csv_path: str, epoch: Optional[int] = None, out_path: str = "snapshot.png"
):
    """Reference ``plot_data.py`` equivalent: render one epoch of the stream."""
    header, data, epochs = load_snapshots(csv_path)
    epoch = int(epochs[-1]) if epoch is None else int(epoch)
    rows = data[data[:, header.index("epoch")] == epoch]
    if rows.shape[0] == 0:
        raise ValueError(f"epoch {epoch} not in snapshot file (has {epochs})")
    preds = {}
    for i, col in enumerate(header):
        if col.endswith("_pred"):
            preds[col[: -len("_pred")]] = rows[:, i : i + 1]
    return plot_solution(ds, preds, out_path=out_path, title=f"epoch {epoch}")
