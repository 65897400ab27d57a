"""The port's CLI takes its own trained model to serving (on the CPU):
``train --resume`` continues a checkpoint to the same state as an
uninterrupted run, ``export --checkpoint`` writes the artifact that
``predict`` and ``eval --artifact`` read, ``eval --checkpoint`` prints the
trainer's evaluation, and every entry point defaults to the card and raises
without one.

The resumed run must equal the uninterrupted one bit for bit: the batches
are Philox draws keyed by (seed, epoch), and the checkpoint holds the whole
state (params, Adam moments and count, ADMM z and dual, the batch).
"""

import json
import os

import numpy as np
import pytest
import torch

from pinns_tpu_torch import cli
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train.trainer import Trainer

SMALL_SETS = {
    "abgrall_admm": ["model.layers=(2, 12, 12, 1)", "sampling.n_f=64"],
    "twosin_weak": ["model.layers=(2, 12, 12, 1)", "sampling.n_f=64"],
    "euler_inverse": ["model.layers=(2, 12, 12, 3)", "sampling.n_f=32", "data.n_u=64"],
    "euler_weak_fast": ["model.layers=(2, 12, 12, 3)", "sampling.n_f=32", "data.n_u=64"],
}


def _sets(preset):
    return [a for s in SMALL_SETS[preset] for a in ("--set", s)]


def _train(preset, out_dir, epochs, *extra):
    return cli.main(["train", "--preset", preset, *_sets(preset), "--epochs", str(epochs),
                     "--out-dir", str(out_dir), "--device", "cpu", *extra])


def _final(out_dir, preset):
    return os.path.join(str(out_dir), f"{preset}_final.ckpt")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("preset", sorted(SMALL_SETS))
def test_resume_equals_an_uninterrupted_run(tmp_path, capsys, preset):
    """6 epochs in one run against 3, a checkpoint, and --resume to 6: the
    states agree bit for bit, and so do the summaries."""
    assert _train(preset, tmp_path / "whole", 6) == 0
    whole = _last_json(capsys)
    assert _train(preset, tmp_path / "first", 3) == 0
    capsys.readouterr()
    assert _train(preset, tmp_path / "rest", 6, "--resume", _final(tmp_path / "first", preset)) == 0
    resumed = _last_json(capsys)
    assert resumed == whole
    a = ckpt_io.state_to_dict(ckpt_io.load_checkpoint(_final(tmp_path / "whole", preset), "cpu"))
    b = ckpt_io.state_to_dict(ckpt_io.load_checkpoint(_final(tmp_path / "rest", preset), "cpu"))
    assert a["epoch"] == b["epoch"] == 6 and a["adam"]["count"] == b["adam"]["count"] == 6

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return []

    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("preset", ["abgrall_admm", "euler_inverse", "euler_weak_fast"])
def test_train_export_predict_eval_round_trip(tmp_path, capsys, preset):
    """train -> export --checkpoint -> predict and eval: the served fields are
    the trainer's prediction, and both evals give the train summary's rel-L2
    (a shock-path net's artifact carries its paths and spec fields)."""
    assert _train(preset, tmp_path / "run", 4) == 0
    summary = _last_json(capsys)
    ckpt = _final(tmp_path / "run", preset)
    art = str(tmp_path / "artifact")
    assert cli.main(["export", "--preset", preset, *_sets(preset), "--checkpoint", ckpt,
                     "--out", art, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == art
    meta = json.load(open(os.path.join(art, "meta.json")))
    assert meta["experiment"] == preset and meta["pde"] == get_preset(preset).pde.kind
    spec = load_params_npz(os.path.join(art, "params.npz"))["spec"]
    assert spec.n_paths == get_preset(preset).model.n_paths

    exp = override(get_preset(preset), cli.parse_sets(SMALL_SETS[preset]))
    trainer = Trainer(exp, device="cpu")
    state = trainer.load_checkpoint(ckpt)
    x = trainer.problem.dataset.X_star[::97]
    np.savez(tmp_path / "pts.npz", x=x)
    out = str(tmp_path / "pred.npz")
    assert cli.main(["predict", "--artifact", art, "--points", str(tmp_path / "pts.npz"),
                     "--out", out, "--device", "cpu"]) == 0
    want = trainer.predict(state.params, x)
    with np.load(out) as z:
        for name in want:
            np.testing.assert_allclose(z[name], want[name], rtol=1e-6, atol=1e-7, err_msg=name)
    capsys.readouterr()

    fields = [k for k in summary if k.startswith("rel_l2_")]
    assert cli.main(["eval", "--preset", preset, *_sets(preset), "--checkpoint", ckpt,
                     "--device", "cpu"]) == 0
    evaluated = _last_json(capsys)
    assert {k: evaluated[k] for k in evaluated if k != "epochs"} == \
        {k: summary[k] for k in summary if k != "epochs"}
    assert cli.main(["eval", "--artifact", art, *_sets(preset), "--device", "cpu"]) == 0
    graded = _last_json(capsys)
    assert graded["experiment"] == preset and graded["truth"] == summary["truth"]
    for k in fields:
        assert graded[k] == pytest.approx(summary[k], rel=1e-6, abs=1e-7), k
    if preset == "euler_inverse":  # the identified viscosity, exp-transformed
        assert summary["lambda2"] == pytest.approx(float(np.exp(state.params["coeffs"]
                                                                ["lambda2"][0])), rel=1e-6)


def test_export_refuses_ensemble_features(tmp_path):
    """JAX's refusals of the ensemble options, before anything is loaded:
    --calibrate with one checkpoint, --select with one, --select with
    --calibrate; and --params with either."""
    for extra, match in ((["--checkpoint", "a.ckpt", "--calibrate"], "needs an ensemble"),
                         (["--checkpoint", "a.ckpt", "--select", "score"], ">= 2 member"),
                         (["--checkpoint", "a.ckpt", "b.ckpt", "--select", "rank",
                           "--calibrate"], "single member")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["export", "--preset", "abgrall_admm", "--out", str(tmp_path), *extra])
    with pytest.raises(SystemExit, match="--params"):
        cli.main(["export", "--params", "p.npz", "--calibrate", "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="--params"):
        cli.main(["export", "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="--checkpoint"):
        cli.main(["eval", "--preset", "abgrall_admm"])


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "twosin_weak", "--epochs", "1"],
    ["train", "--preset", "abgrall_admm", "--epochs", "1", "--resume", "x.ckpt"],
    ["export", "--preset", "abgrall_admm", "--checkpoint", "x.ckpt", "--out", "o"],
    ["eval", "--preset", "abgrall_admm", "--checkpoint", "x.ckpt"],
    ["eval", "--artifact", "a"],
], ids=["train", "resume", "export", "eval-checkpoint", "eval-artifact"])
def test_entry_points_default_to_the_card(monkeypatch, argv):
    """Without --device each command asks for cuda, and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(argv)
