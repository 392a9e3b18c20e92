"""The port's models against the Flax models with the same weights (carried
over by ``interop.params_from_flax``), f32, dropout off. Products of f32
values summed in another order: the bar is 1e-5."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu_torch.configuration import load_test_configuration
from mri_inr_tpu_torch.interop import load_flax_params, params_from_flax
from mri_inr_tpu_torch.models.encoder import LatentEncoder
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren, from_config

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


@functools.lru_cache(maxsize=None)
def _jax_model(patch, kw):
    widths = dict(dim_hidden=64, latent_dim=32, num_layers=3, dropout=0.1,
                  outer_patch_size=patch, **dict(kw))
    tiles = np.random.default_rng(1).uniform(size=(6, patch, patch)).astype(np.float32)
    jm = JaxModel(**widths)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(tiles))["params"])
    return widths, jm, params, tiles


def _pair(patch=32, **kw):
    widths, jm, params, tiles = _jax_model(patch, tuple(sorted(kw.items())))
    tm = ModulatedSiren(**widths, device="cpu").eval()
    load_flax_params(tm, params)
    return jm, params, tm, tiles


@pytest.mark.parametrize("kw", [{}, {"activation": "morlet"}, {"residual": True},
                                {"exact_sine": True}],
                         ids=["sine", "morlet", "residual", "exact_sine"])
def test_forward_matches_flax(kw):
    jm, params, tm, tiles = _pair(**kw)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tiles), deterministic=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(tiles)).numpy()
    assert got.shape == want.shape == (6, 24, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("patch", [32, 48])
def test_encode_matches_flax(patch):
    """At 48x48 conv3 leaves a 5x5 map, so the flatten order matters: the
    port flattens in the NHWC order of the Flax ``fc`` weight."""
    jm, params, tm, tiles = _pair(patch=patch)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tiles), method=jm.encode))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(tiles)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_modulations_match_flax():
    jm, params, tm, tiles = _pair()
    want = jm.apply({"params": params}, jnp.asarray(tiles), method=jm.modulations)
    with torch.no_grad():
        got = tm.modulations(torch.from_numpy(tiles))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_transplant_covers_every_parameter():
    _, params, tm, _ = _pair()
    assert set(params_from_flax(params)) == set(tm.state_dict())


def test_dropout_only_in_train_mode():
    _, _, tm, tiles = _pair()
    x = torch.from_numpy(tiles)
    with torch.no_grad():
        a, b = tm(x), tm(x)
        tm.train()
        c = tm(x)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_bf16_compute_dtype_close_to_f32():
    jm, params, _, tiles = _pair()
    tm16 = ModulatedSiren(dim_hidden=64, latent_dim=32, num_layers=3,
                          compute_dtype=torch.bfloat16, device="cpu").eval()
    load_flax_params(tm16, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tiles), deterministic=True))
    with torch.no_grad():
        got = tm16(torch.from_numpy(tiles))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() < 5e-2


def test_seeded_init_follows_the_generator():
    make = lambda seed: ModulatedSiren(
        dim_hidden=64, latent_dim=32, num_layers=3, device="cpu",
        generator=torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.layers.1.weight"], c["net.layers.1.weight"])
    # SIREN layers: U(-s, s); layer 0 s = 1/dim_in, later sqrt(6/dim_in)/w0
    assert a["net.layers.0.weight"].abs().max() <= 0.5
    assert a["net.layers.1.weight"].abs().max() <= (6 / 64) ** 0.5
    # Flax-default dense/conv init: truncated normal, zero bias
    assert a["modulator.layers.0.weight"].abs().max() <= 2 * (1 / 32) ** 0.5 / 0.8796
    assert torch.count_nonzero(a["encoder.encoder.conv1.bias"]) == 0


def test_from_config_full_width():
    cfg = load_test_configuration(CONFIGS / "test.yaml")
    model = from_config(cfg.model, device="cpu")
    assert model.net.layers[1].weight.shape == (256, 256)
    assert model.modulator.layers[4].weight.shape == (256, 512)
    assert len(model.net.layers) == 5


def test_vgg_encoder_is_a_latent_encoder():
    enc = LatentEncoder(latent_dim=24, encoder_type="vgg")
    assert type(enc.encoder).__name__ == "VGGEncoder"
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 32, 32)).astype(np.float32))
    assert enc(x).shape == (2, 24)
    model = ModulatedSiren(dim_hidden=32, latent_dim=24, num_layers=2, encoder_type="vgg",
                           device="cpu")
    assert model(x).shape == (2, 24, 24)
    with pytest.raises(ValueError, match="encoder_type"):
        LatentEncoder(encoder_type="resnet")
