"""The port's VGG trunk, VGG encoder and VGG autoencoder against the JAX
package's Flax modules on the CPU, from Flax ``init`` weights transplanted
by ``interop``, at batch 2: 1e-4 relative to the largest output; and
``params_to_flax`` undoing ``params_from_flax`` on their trees, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.models import encoder as tenc
torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _patches(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _transplant(module, params):
    module.load_state_dict(interop.params_from_flax(_np(params)), strict=True)
    return module


def _assert_round_trip(params):
    back = interop.params_to_flax(interop.params_from_flax(params))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        assert flat_b[k].shape == v.shape and np.array_equal(flat_b[k], v), k


@pytest.fixture(scope="module")
def vgg_autoencoder():
    x = _patches((2, 32, 32), seed=4)
    jm = jenc.VGGAutoencoder()
    params = jax.jit(jm.init)(jax.random.key(5), jnp.asarray(x))["params"]
    return x, jm, params


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_vgg_trunk_matches_flax(vgg_autoencoder):
    x, _, params = vgg_autoencoder
    trunk = _transplant(tenc.VGGTrunk(), params["trunk"])
    assert trunk.conv_0.bias is None and trunk.conv_1.bias is not None
    want = np.asarray(jenc.VGGTrunk().apply({"params": params["trunk"]}, jnp.asarray(x)))
    got = trunk(torch.from_numpy(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 1, 1, 512)
    assert _rel(got, want) <= 1e-4


def test_vgg_autoencoder_matches_flax(vgg_autoencoder):
    x, jm, params = vgg_autoencoder
    tm = _transplant(tenc.VGGAutoencoder(), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 32, 32)
    assert _rel(got, want) <= 1e-4


def test_vgg_encoder_matches_flax():
    x = _patches((2, 32, 32), seed=6)
    jm = jenc.LatentEncoder(latent_dim=40, encoder_type="vgg")
    params = jm.init(jax.random.key(7), jnp.asarray(x))["params"]
    tm = _transplant(tenc.LatentEncoder(40, "vgg"), params)
    assert isinstance(tm.encoder, tenc.VGGEncoder)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 40)
    assert _rel(got, want) <= 1e-4


def test_vgg_encoder_bf16_follows_the_compute_dtype():
    gen = torch.Generator().manual_seed(0)
    enc = tenc.VGGEncoder(16, compute_dtype=torch.bfloat16, generator=gen)
    f32 = tenc.VGGEncoder(16, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_patches((2, 32, 32), seed=8))
    out, ref = enc(x), f32(x)
    assert out.dtype == torch.bfloat16 and enc.fc.weight.dtype == torch.float32
    assert (out.float() - ref).abs().max() <= 5e-2 * ref.abs().max()


@pytest.mark.parametrize("tree", ["vgg_autoencoder", "vgg_encoder"])
def test_params_round_trip(tree, vgg_autoencoder):
    if tree == "vgg_autoencoder":
        params = _np(vgg_autoencoder[2])
    else:
        jm = jenc.LatentEncoder(latent_dim=16, encoder_type="vgg")
        params = _np(jm.init(jax.random.key(0), jnp.zeros((1, 32, 32)))["params"])
    _assert_round_trip(params)
