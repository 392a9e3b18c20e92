"""The port's configuration loader against the JAX package's: every shipped
YAML gives the same dictionary, and overrides and validation behave alike."""

import pathlib

import pytest

from mri_inr_tpu.configuration import config as jc
from mri_inr_tpu_torch.configuration import config as tc

CONFIG_DIR = pathlib.Path(__file__).resolve().parent.parent / "configs"
CONFIGS = sorted(CONFIG_DIR.rglob("*.yaml"))


def _loaders(path):
    if path.name.startswith("test"):
        return jc.load_test_configuration, tc.load_test_configuration
    return jc.load_train_configuration, tc.load_train_configuration


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(CONFIG_DIR)))
def test_every_config_loads_the_same(path):
    jax_load, port_load = _loaders(path)
    assert tc.to_dict(port_load(path)) == jc.to_dict(jax_load(path))


def test_overrides_match():
    overrides = ["data.sin5=false", "data.batch_patches=512", "model.activation=Morlet",
                 "data.metric_samples=1e2"]
    path = CONFIG_DIR / "test.yaml"
    got = tc.load_test_configuration(path, overrides)
    want = jc.load_test_configuration(path, overrides)
    assert tc.to_dict(got) == jc.to_dict(want)
    assert got.model.activation == "morlet" and got.data.sin5 is False
    train = ["training.lr=1e-3", "training.criterion=Edge"]
    assert tc.to_dict(tc.load_train_configuration(None, train)) == jc.to_dict(
        jc.load_train_configuration(None, train))


@pytest.mark.parametrize("bad", ["model.bogus=1", "model.activation=relu", "data.sin5"])
def test_invalid_overrides_raise(bad):
    with pytest.raises(ValueError):
        tc.load_test_configuration(None, [bad])


def test_unknown_yaml_keys_raise(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("model:\n  dim_hiden: 64\n")
    with pytest.raises(ValueError, match="dim_hiden"):
        tc.load_test_configuration(p)
