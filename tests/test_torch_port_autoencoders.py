"""The port's conv autoencoder and its pieces against the JAX package's Flax
modules on the CPU, from Flax ``init`` weights transplanted by ``interop``;
inputs from a numpy seed (the VGG modules: ``test_torch_port_vgg.py``).

- each Flax ``ConvTranspose`` case on its own (the flip, the ``(in, out,
  kh, kw)`` layout and, for 3x3 stride 2 ``"SAME"``, the asymmetric crop):
  max 1e-5;
- ``ConvDecoder`` / ``ConvAutoencoder`` in f32: max 1e-5;
- three Adam steps (lr 1e-3) of the conv autoencoder (the ``train_encoder
  --model conv`` step) against ``optax.adam``: losses and parameters within
  1e-5;
- ``adaptive_avg_pool_2d`` down and up on odd sizes: 1e-6, its gradient
  1e-6 relative;
- ``params_to_flax`` undoes ``params_from_flax`` on the trees, bit for bit.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.models import encoder as tenc
from mri_inr_tpu_torch.train.trainer import make_optimizer

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _patches(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _transplant(module, params):
    module.load_state_dict(interop.params_from_flax(_np(params)), strict=True)
    return module


class _FlaxDeconv(fnn.Module):
    features: int
    kernel: int
    stride: int
    padding: str

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(self.features, (self.kernel, self.kernel),
                                 strides=(self.stride, self.stride), padding=self.padding,
                                 name="deconv")(x)


# (cin, cout, kernel, stride, padding, input side): the decoders' cases
DECONV_CASES = {
    "deconv1_8x8_valid": (64, 32, 8, 1, "VALID", 1),
    "deconv2_3x3_s2_same": (32, 16, 3, 2, "SAME", 8),
    "deconv3_3x3_s2_same": (16, 1, 3, 2, "SAME", 16),
    "up_2x2_s2_same": (64, 32, 2, 2, "SAME", 3),
    "odd_3x3_s2_same": (3, 5, 3, 2, "SAME", 5),
}


@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_conv_transpose_matches_flax(case):
    cin, cout, k, s, pad, side = DECONV_CASES[case]
    x = _patches((2, side, side, cin), seed=side)
    fm = _FlaxDeconv(cout, k, s, pad)
    params = fm.init(jax.random.key(1), jnp.asarray(x))["params"]
    params["deconv"]["bias"] = jnp.asarray(_patches((cout,), 9)) - 0.5
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = tenc.ConvTranspose(cin, cout, k, s, pad)
    # the interop's rule picks a ConvTranspose by its Flax name (deconv)
    tm.load_state_dict({k_[len("deconv."):]: v for k_, v in
                        interop.params_from_flax(_np(params)).items()})
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "deconv2_3x3_s2_same":
        # no symmetric padding of ConvTranspose2d gives Flax's window
        w = tm.weight.detach()
        full = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), w, tm.bias.detach(), stride=2)
        sym = full[..., 1:, 1:].permute(0, 2, 3, 1).numpy()
        assert np.abs(sym - want).max() > 1e-3


def test_conv_autoencoder_matches_flax():
    x = _patches((3, 32, 32))
    jm = jenc.ConvAutoencoder(latent_dim=48)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    tm = _transplant(tenc.ConvAutoencoder(48), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    z = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    np.testing.assert_allclose(tm.encode(torch.from_numpy(x)).detach().numpy(), np.asarray(z),
                               rtol=0, atol=1e-5)


def test_conv_decoder_matches_flax():
    z = _patches((4, 48), seed=2) - 0.5
    jm = jenc.ConvDecoder()
    params = jm.init(jax.random.key(3), jnp.asarray(z))["params"]
    tm = _transplant(tenc.ConvDecoder(48), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z)))
    got = tm(torch.from_numpy(z)).detach().numpy()
    assert got.shape == (4, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_three_adam_steps_of_the_conv_autoencoder_match_optax():
    x = np.random.default_rng(0).uniform(size=(8, 32, 32)).astype(np.float32)
    jm = jenc.ConvAutoencoder(latent_dim=16)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    tm = tenc.ConvAutoencoder(16)
    tm.load_state_dict(interop.params_from_flax(jax.device_get(params)), strict=True)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    opt = make_optimizer("adam", 1e-3, tm.parameters())

    @jax.jit
    def jstep(params, opt_state, x):
        loss, g = jax.value_and_grad(lambda p: jnp.mean(jnp.square(jm.apply({"params": p}, x)
                                                                   - x)))(params)
        upd, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    xt = torch.from_numpy(x)
    for _ in range(3):
        params, opt_state, jl = jstep(params, opt_state, jnp.asarray(x))
        opt.zero_grad()
        loss = torch.mean(torch.square(tm(xt) - xt))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0, atol=1e-5)
    got = interop.params_from_flax(jax.device_get(params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("size,out", [((9, 13), (7, 7)), ((1, 1), (7, 7)), ((5, 3), (7, 7)),
                                      ((11, 7), (3, 5))], ids=str)
def test_adaptive_avg_pool_matches_jax(size, out):
    x = _patches((2, 3, *size), seed=size[0])
    want = np.asarray(jenc.adaptive_avg_pool_2d(jnp.asarray(x.transpose(0, 2, 3, 1)), out))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tenc.adaptive_avg_pool_2d(xt, out)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    # the gradient, against torch's own adaptive pool and JAX's (sums of up
    # to 49 cotangents of about 0.5 in another order: 1e-6 relative)
    cot = torch.from_numpy(_patches(got.shape, seed=5))
    (g,) = torch.autograd.grad(got, xt, cot)
    ref = torch.from_numpy(x).requires_grad_(True)
    (g_ref,) = torch.autograd.grad(torch.nn.functional.adaptive_avg_pool2d(ref, out), ref, cot)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-6, atol=1e-6)
    _, vjp = jax.vjp(lambda a: jenc.adaptive_avg_pool_2d(a, out), jnp.asarray(x.transpose(0, 2, 3, 1)))
    (jg,) = vjp(jnp.asarray(cot.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg).transpose(0, 3, 1, 2), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("tree", ["conv_autoencoder", "conv_decoder"])
def test_params_round_trip(tree):
    jm = jenc.ConvAutoencoder(latent_dim=16) if tree == "conv_autoencoder" else jenc.ConvDecoder()
    x = jnp.zeros((1, 32, 32)) if tree == "conv_autoencoder" else jnp.zeros((1, 16))
    params = _np(jm.init(jax.random.key(0), x)["params"])
    _assert_round_trip(params)


def _assert_round_trip(params):
    back = interop.params_to_flax(interop.params_from_flax(params))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        assert flat_b[k].shape == v.shape and np.array_equal(flat_b[k], v), k
