"""P6's common start: JAX's seed-1234 ``burgers_forward`` state in the
committed fixture (``scripts/make_torch_p6_fixture.py``), the port's
``TrainState`` built from it (``scripts/p6_port_run.py::jax_start``), and a
few teacher-forced steps of both packages from it (``scripts/p6_replay.py``)
within the training row's per-step tolerance (tests/test_torch_train.py:
metrics rtol 1e-4 / atol 1e-6; params within 2 lr of JAX's, at most 1% of
the entries beyond 1e-6).
"""

import importlib.util
import os

import jax
import numpy as np
import torch

from pinns_tpu.config import override
from pinns_tpu.experiments import get_preset
from pinns_tpu.train import Trainer
from pinns_tpu.train.trainer import make_adam_step
from pinns_tpu_torch.config import override as toverride
from pinns_tpu_torch.experiments import get_preset as tget_preset
from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.train import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "burgers_forward_init.npz")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_trainer():
    return Trainer(override(get_preset("burgers_forward"), {"train.seed": 1234}))


def test_fixture_is_jax_seed_1234_start():
    state = _jax_trainer().init_state()
    loaded = load_params_npz(FIXTURE)
    assert loaded["spec"].layers == (2,) + (20,) * 8 + (1,)
    for got, want in zip(loaded["params"], jax.device_get(state.params["net"])):
        np.testing.assert_array_equal(got["W"], want["W"])
        np.testing.assert_array_equal(got["b"], want["b"])
    with np.load(FIXTURE) as z:
        np.testing.assert_array_equal(z["colloc"], np.asarray(state.colloc))
        assert int(z["seed"]) == 1234 and z["colloc"].shape == (10_456, 2)


def test_port_steps_like_jax_from_the_jax_start():
    """The replay script's check at epoch 0: three teacher-forced steps of
    the port's generic step and JAX's make_adam_step from JAX's states."""
    replay = _script("p6_replay")
    jt = _jax_trainer()
    tt = ttrainer.Trainer(toverride(tget_preset("burgers_forward"), {"train.seed": 1234}),
                          device="cpu")
    start = _script("p6_port_run").jax_start(tt, FIXTURE)
    jstate = jt.init_state()
    assert np.array_equal(start.colloc.numpy(), np.asarray(jstate.colloc))
    jstep = jax.jit(make_adam_step(jt.problem, jt.optimizer))
    out = replay.replay(jstep, ttrainer.make_step(tt.problem, tt.learning_rate),
                        tt.learning_rate, jstate, 3)
    assert out["first_beyond_tolerance"] is None, out
    assert out["worst_metric_ratio"] <= 1.0 and out["worst_param_ratio"] <= 1.0 + 1e-3
