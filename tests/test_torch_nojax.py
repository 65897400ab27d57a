"""The port stands alone: no jax, no pinns_tpu, no CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

from pinns_tpu_torch.device import resolve_device
from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "pinns_tpu_torch", "pinns_tpu_torch.cli", "pinns_tpu_torch.device",
    "pinns_tpu_torch.interop", "pinns_tpu_torch.models.mlp", "pinns_tpu_torch.ops.taylor",
    "pinns_tpu_torch.ops.residuals", "pinns_tpu_torch.ops.kernels.build",
    "pinns_tpu_torch.ops.kernels.taylor2", "pinns_tpu_torch.serve",
    "pinns_tpu_torch.train.evaluate", "pinns_tpu_torch.config",
    "pinns_tpu_torch.experiments", "pinns_tpu_torch.experiments.presets",
    "pinns_tpu_torch.data.datasets", "pinns_tpu_torch.data.sampling", "pinns_tpu_torch.ops.prox",
    "pinns_tpu_torch.losses.misfit", "pinns_tpu_torch.losses.admm", "pinns_tpu_torch.opt.adam",
    "pinns_tpu_torch.train.trainer", "pinns_tpu_torch.train.metrics",
    "pinns_tpu_torch.train.checkpoint", "pinns_tpu_torch.ops.kernels.fused_step",
    "pinns_tpu_torch.ops.kernels.mlp_forward", "pinns_tpu_torch.opt.lbfgs",
    "pinns_tpu_torch.data.generators", "pinns_tpu_torch.ops.kernels.taylor1",
    "pinns_tpu_torch.ops.weakform", "pinns_tpu_torch.ops.kernels.weakform",
    "pinns_tpu_torch.ops.kernels.lbfgs", "pinns_tpu_torch.train.schedule",
    "pinns_tpu_torch.ops.kernels.sampling", "pinns_tpu_torch.ops.kernels.generic_chunk",
    "pinns_tpu_torch.ops.kernels.ensemble", "pinns_tpu_torch.parallel.ensemble",
    "pinns_tpu_torch.parallel.sweep", "pinns_tpu_torch.train.polish",
    "pinns_tpu_torch.parallel.mesh", "pinns_tpu_torch.parallel.sharding",
]


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pinns_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="unsupported"):
        resolve_device("meta")


def test_resolve_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_wrapper_raises_on_cpu_tensor():
    spec = MLPSpec(layers=(2, 8, 1), lb=(-1.0, 0.0), ub=(1.0, 1.0))
    params = init_mlp(spec, torch.Generator().manual_seed(0), torch.device("cpu"))
    before = k_taylor2.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_taylor2.taylor2(spec, params, torch.zeros(4, 2))
    assert k_taylor2.LAUNCHES == before


def _entry_points(tmp_path):
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.serve import ServedModel, load_exported, make_http_server
    from pinns_tpu_torch.train import checkpoint, trainer

    exp = get_preset("abgrall_admm")
    missing = str(tmp_path / "missing")  # read only after the device is resolved
    return {
        "Trainer": lambda: trainer.Trainer(exp),
        "build_problem": lambda: trainer.build_problem(exp),
        "ServedModel": lambda: ServedModel(missing),
        "load_exported": lambda: load_exported(missing),
        "make_http_server": lambda: make_http_server(missing, port=0),
        "load_checkpoint": lambda: checkpoint.load_checkpoint(missing),
    }


@pytest.mark.parametrize("entry", ["Trainer", "build_problem", "ServedModel", "load_exported",
                                   "make_http_server", "load_checkpoint"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Called without a device on a machine with no card, each Python entry
    point raises RuntimeError from resolve_device before it reads a file or
    loads data: none of them runs on the CPU unless asked to."""
    from pinns_tpu_torch.train import trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_data(*args, **kwargs):
        raise AssertionError("the data was loaded: the entry point ran on the CPU")

    monkeypatch.setattr(trainer, "load_burgers_mat", no_data)
    with pytest.raises(RuntimeError, match="is_available"):
        _entry_points(tmp_path)[entry]()
