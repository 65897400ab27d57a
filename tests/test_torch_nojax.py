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
    "pinns_tpu_torch.train.evaluate",
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
