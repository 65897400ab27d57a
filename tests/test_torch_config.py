"""The port's config and preset mirror equals the JAX package's, field for field."""

import dataclasses

import pytest

from pinns_tpu import config as jconfig
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu_torch import config as tconfig
from pinns_tpu_torch.experiments import PRESETS, get_preset

DATACLASSES = ["ModelConfig", "PDEConfig", "SamplingConfig", "LossConfig", "LBFGSConfig",
               "OptimizerConfig", "DataConfig", "MeshConfig", "TrainConfig", "Experiment"]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults_match_jax(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert t.__dataclass_params__.frozen


def test_preset_names_match_jax():
    assert list(PRESETS) == list(JPRESETS)
    with pytest.raises(KeyError, match="unknown preset"):
        get_preset("no_such_preset")


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_preset_equals_jax_field_for_field(name):
    assert dataclasses.asdict(get_preset(name)) == dataclasses.asdict(JPRESETS[name])


def test_override_matches_jax():
    updates = {"sampling.n_f": 64, "model.layers": (2, 16, 1), "name": "x",
               "optimizer.lbfgs.history": 7, "loss.rho": 3.0}
    got = tconfig.override(get_preset("abgrall_admm"), updates)
    want = jconfig.override(JPRESETS["abgrall_admm"], updates)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert get_preset("abgrall_admm").sampling.n_f == 1000  # the preset is untouched
