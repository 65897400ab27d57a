"""The port's float32 numerics do not depend on what ran before it in the
process.

PyTorch keeps the float32 matmul precision and TF32 in process-global
switches, and any earlier code in a test worker (or an application) can lower
them: "medium" routes CPU float32 matmuls through oneDNN in bf16. The port
pins them at every entry point (``device.pin_numerics``), so the served
fixture and a training step give the same answer after another caller
lowered them. Each case sets a lowered switch first, in the order that
breaks an unpinned port, and restores the process's switches after.
"""

import numpy as np
import pytest
import torch

from pinns_tpu_torch.device import check_numerics, pin_numerics, resolve_device
from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.serve import ServedModel, export_predict
from torch_port_util import FIXTURE, assert_close


def _lower_legacy():
    torch.set_float32_matmul_precision("medium")


def _lower_onednn():
    torch.backends.mkldnn.matmul.fp32_precision = "bf16"


def _lower_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


LOWER = {"legacy-medium": _lower_legacy, "onednn-bf16": _lower_onednn, "tf32": _lower_tf32}


@pytest.fixture
def restore_switches():
    yield
    pin_numerics()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    loaded = load_params_npz(FIXTURE)
    art = export_predict(loaded["spec"], loaded["params"], str(tmp_path_factory.mktemp("n") / "m"),
                         lambda1=loaded["lambda1"], lambda2=loaded["lambda2"])
    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in ("X_star", "u_jax", "f_jax")}
    return ServedModel(art, device="cpu"), fx


@pytest.mark.parametrize("lower", sorted(LOWER))
def test_served_fixture_after_lowered_precision(served, lower, restore_switches):
    model, fx = served  # built before the switch was lowered, as a server is
    LOWER[lower]()
    out = model.predict(fx["X_star"], pad_to_bucket=True)
    for k in ("u", "f"):
        assert_close(k, out[k], fx[f"{k}_jax"])
    check_numerics()  # predict left the switches pinned


def test_lowered_precision_does_change_an_unpinned_matmul(restore_switches):
    """The hazard the pinning guards against, on this CPU: bf16 matmuls move
    a float32 product by far more than the fixture tolerance."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 20)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((20, 20)).astype(np.float32))
    exact = a.double() @ b.double()
    full = float(((a @ b).double() - exact).abs().max())
    _lower_legacy()
    lowered = float(((a @ b).double() - exact).abs().max())
    pin_numerics()
    assert full < 1e-5
    if lowered == full:
        pytest.skip("this CPU runs bf16 'medium' matmuls in full float32")
    assert lowered > 100 * full


def test_training_step_after_lowered_precision(restore_switches):
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(get_preset("abgrall_admm"), {
        "model.layers": (2, 16, 16, 1), "sampling.n_f": 32, "data.n_u": 8,
        "train.epochs": 2, "train.chunk": 2, "train.log_every": 0})
    trainer = Trainer(exp, device="cpu")
    _, want = trainer.train()
    _lower_legacy()
    _, got = trainer.train()
    assert got == want


def test_resolve_device_checks_what_it_pins(restore_switches, monkeypatch):
    _lower_legacy()
    assert resolve_device("cpu") == torch.device("cpu")
    check_numerics()
    _lower_legacy()
    monkeypatch.setattr(torch, "set_float32_matmul_precision", lambda p: None)
    with pytest.raises(RuntimeError, match="reduced-precision"):
        resolve_device("cpu")
