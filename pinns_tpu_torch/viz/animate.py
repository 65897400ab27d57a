"""Convergence animations from the snapshot CSV stream (port of
``pinns_tpu/viz/animate.py``).

Reference parity: ``figures/**/animate_plot.py`` (4 byte-identical copies) —
iterate the epochs recorded in the convergence CSV and render an MP4 via
``matplotlib.animation.FuncAnimation`` + ffmpeg
(``animate_plot.py:133-141``). Falls back to GIF (pillow) when ffmpeg is not
available.
"""

from __future__ import annotations

import shutil
from typing import Optional

from pinns_tpu_torch.viz.plots import _pyplot, load_snapshots


def animate_snapshots(
    ds,
    csv_path: str,
    field: Optional[str] = None,
    out_path: str = "convergence.mp4",
    fps: int = 5,
    slice_frac: float = 0.5,
):
    """Animate heatmap + mid-time slice of `field` across recorded epochs."""
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    header, data, epochs = load_snapshots(csv_path)
    field = field or ds.field_names[0]
    col = header.index(f"{field}_pred")
    ep_col = header.index("epoch")
    nt, nx = ds.fields[field].shape
    ti = int(nt * slice_frac)
    exact = ds.fields[field]

    frames = []
    for e in epochs:
        rows = data[data[:, ep_col] == e]
        frames.append((int(e), rows[:, col].reshape(nt, nx)))

    vmin = min(exact.min(), min(f.min() for _, f in frames))
    vmax = max(exact.max(), max(f.max() for _, f in frames))

    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(12, 4.5))
    im = ax0.imshow(
        frames[0][1].T,
        interpolation="nearest",
        cmap="rainbow",
        extent=[ds.t.min(), ds.t.max(), ds.x.min(), ds.x.max()],
        origin="lower",
        aspect="auto",
        vmin=vmin,
        vmax=vmax,
    )
    fig.colorbar(im, ax=ax0, fraction=0.046)
    ax0.set_xlabel("$t$")
    ax0.set_ylabel("$x$")
    title = ax0.set_title(f"${field}(t,x)$ — epoch {frames[0][0]}")

    (ln_exact,) = ax1.plot(ds.x.ravel(), exact[ti], "b-", lw=2, label="Exact")
    (ln_pred,) = ax1.plot(ds.x.ravel(), frames[0][1][ti], "r--", lw=2, label="Prediction")
    ax1.set_xlabel("$x$")
    ax1.set_ylabel(f"${field}$")
    ax1.set_title(f"$t = {float(ds.t[ti, 0]):.2f}$")
    ax1.legend()
    ax1.set_ylim(vmin - 0.1, vmax + 0.1)

    def update(i):
        e, grid = frames[i]
        im.set_data(grid.T)
        ln_pred.set_ydata(grid[ti])
        title.set_text(f"${field}(t,x)$ — epoch {e}")
        return im, ln_pred, title

    anim = FuncAnimation(fig, update, frames=len(frames), blit=False)
    if out_path.endswith(".mp4") and shutil.which("ffmpeg"):
        anim.save(out_path, writer="ffmpeg", fps=fps)
    else:
        if out_path.endswith(".mp4"):
            out_path = out_path[:-4] + ".gif"
        anim.save(out_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
