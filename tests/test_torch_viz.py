"""The port's viz layer and the CLI's ``presets`` / ``plot`` / ``animate``
on the CPU, against the JAX package's where both read the same files.

A tiny port run (``abgrall_admm``, 20 epochs, a snapshot every 10) gives a
checkpoint and a snapshot CSV; ``plot`` and ``animate`` must write their
files from them. Exact checks only: the snapshot reader's arrays and the
presets' lines equal JAX's.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from pinns_tpu import cli as jcli  # noqa: E402
from pinns_tpu.viz import plots as jplots  # noqa: E402
from pinns_tpu_torch import cli as tcli  # noqa: E402
from pinns_tpu_torch.viz import plots as tplots  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "abgrall_admm"


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("viz_run")
    _run(tcli.main, ["train", "--preset", PRESET, "--epochs", "20", "--chunk", "10", "--set",
                     "train.snapshot_every=10", "--set", "train.log_every=10",
                     "--out-dir", str(out), "--device", "cpu"])
    return out


def test_presets_prints_jax_lines():
    assert _run(tcli.main, ["presets"]) == _run(jcli.main, ["presets"])


def test_snapshot_reader_matches_jax(run_dir):
    csv = str(run_dir / f"{PRESET}_snapshots.csv")
    header, data, epochs = tplots.load_snapshots(csv)
    jheader, jdata, jepochs = jplots.load_snapshots(csv)
    assert header == jheader == ["x", "t", "u_pred", "epoch"]
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(epochs, jepochs)
    assert list(epochs) == [10, 20]


@pytest.mark.parametrize("source", ["checkpoint", "snapshots"])
def test_plot_writes_the_figure(run_dir, source, tmp_path):
    out = str(tmp_path / f"{source}.png")
    arg = (["--checkpoint", str(run_dir / f"{PRESET}_final.ckpt")] if source == "checkpoint"
           else ["--snapshots", str(run_dir / f"{PRESET}_snapshots.csv"), "--epoch", "10"])
    printed = _run(tcli.main, ["plot", "--preset", PRESET, *arg, "--out", out,
                               "--device", "cpu"])
    assert printed.strip() == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_of_a_missing_epoch_raises(run_dir, tmp_path):
    with pytest.raises(ValueError, match="epoch 15"):
        _run(tcli.main, ["plot", "--preset", PRESET, "--snapshots",
                         str(run_dir / f"{PRESET}_snapshots.csv"), "--epoch", "15",
                         "--out", str(tmp_path / "x.png"), "--device", "cpu"])


def test_animate_writes_the_animation(run_dir, tmp_path):
    out = str(tmp_path / "convergence.mp4")
    printed = _run(tcli.main, ["animate", "--preset", PRESET, "--snapshots",
                               str(run_dir / f"{PRESET}_snapshots.csv"), "--out", out,
                               "--device", "cpu"]).strip()
    # an mp4 with ffmpeg on PATH, else a GIF beside it (JAX's fallback)
    assert printed in (out, out[:-4] + ".gif") and os.path.getsize(printed) > 0


def test_plot_uncertainty_draws_calibrated_bands(run_dir, tmp_path):
    from pinns_tpu_torch.data.datasets import load_burgers_mat

    ds = load_burgers_mat("twosin_burgers_shock")
    rng = np.random.default_rng(0)
    members = ds.star["u"][None] + 0.01 * rng.standard_normal((3,) + ds.star["u"].shape)
    uq = {"u": {"mean": members.mean(0), "std": members.std(0), "members": members}}
    cal = {"u": {"k_conf95": 2.5, "mond_feature": "std", "mond_edges": [0.005, 0.01],
                 "mond_k": [2.0, 2.5, 3.0]}}
    out = tplots.plot_uncertainty(ds, uq, out_path=str(tmp_path / "uq.png"), calibration=cal)
    assert os.path.getsize(out) > 0


def test_plotting_without_matplotlib_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tplots._pyplot()


def test_cli_and_viz_import_without_matplotlib():
    """The card's machine has no matplotlib: importing the CLI and the viz
    package must not load it."""
    code = ("import sys\nimport pinns_tpu_torch.cli, pinns_tpu_torch.viz\n"
            "sys.exit(1 if 'matplotlib' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
