"""The port's k-space functions (``mri_inr_tpu_torch/data/kspace.py``)
against the JAX package's on the same seeded numpy inputs.

Tolerances: the FFTs are float32 library transforms in both frameworks with
different butterflies, 2e-5 * max(|ref|, 1) (the JAX package's own bar for
its DFT kernel against its FFT); masking and min-max are one multiply or one
subtract-and-divide, 1e-6. The mask draw is ``jax.random``'s under the same
key, so masks are held equal, bit for bit: for 200 stems and every (cf,
acc) pair the protocol preprocesses, at the protocol's width and fastMRI's;
the expected retained fraction keeps the JAX test's bar (0.01 over 200
draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.data import kspace as jk
from mri_inr_tpu.data import preprocessing as jpre
from mri_inr_tpu_torch.data import kspace as tk
from mri_inr_tpu_torch.data import preprocessing as tpre
from mri_inr_tpu_torch.utils import jax_random as jr

torch.set_num_threads(1)


def _kspace(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))).astype(np.complex64)


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 96, 64), (3, 63, 33)], ids=str)
@pytest.mark.parametrize("name", ["ifft2c", "fft2c"])
def test_centred_ffts_match(shape, name):
    k = _kspace(shape, seed=1, scale=10.0)
    got = getattr(tk, name)(torch.from_numpy(k)).numpy()
    _close(got, getattr(jk, name)(jnp.asarray(k)))


@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 63, 33)], ids=str)
def test_reconstruct_magnitude_matches(shape):
    k = _kspace(shape, seed=2, scale=10.0)
    got = tk.reconstruct_magnitude(torch.from_numpy(k)).numpy()
    _close(got, jk.reconstruct_magnitude(jnp.asarray(k)))
    ri = jk.to_ri(k)
    np.testing.assert_array_equal(tk.to_ri(k), ri)
    got = tk.reconstruct_magnitude_ri(torch.from_numpy(ri)).numpy()
    _close(got, jk.reconstruct_magnitude_ri(jnp.asarray(ri)))
    assert got.dtype == np.float32


def test_fft_roundtrip_and_dc():
    x = torch.from_numpy(_kspace((4, 64, 64), seed=3))
    np.testing.assert_allclose(tk.ifft2c(tk.fft2c(x)).numpy(), x.numpy(), atol=1e-5)
    k = tk.fft2c(torch.ones((16, 16), dtype=torch.complex64)).numpy().copy()
    assert abs(k[8, 8]) > 1.0
    k[8, 8] = 0
    np.testing.assert_allclose(k, 0, atol=1e-5)


def test_masking_and_normalisation_match():
    k = _kspace((2, 8, 12), seed=4)
    mask = np.random.default_rng(5).uniform(size=12) < 0.5
    got = tk.apply_mask(torch.from_numpy(k), mask).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.apply_mask(jnp.asarray(k), jnp.asarray(mask))),
                               rtol=0, atol=1e-6)
    assert (got[..., ~mask] == 0).all()
    ri = tk.to_ri(k)
    got = tk.apply_mask_ri(torch.from_numpy(ri), mask).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jk.apply_mask_ri(jnp.asarray(ri), jnp.asarray(mask))), rtol=0, atol=1e-6)
    assert (got[:, :, ~mask, :] == 0).all() and (got[:, :, mask, :] == ri[:, :, mask, :]).all()
    vol = np.random.default_rng(6).uniform(2, 9, size=(3, 5, 7)).astype(np.float32)
    got = tk.normalize_scan(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.normalize_scan(jnp.asarray(vol))),
                               rtol=0, atol=1e-6)
    assert got.min() == 0.0 and got.max() == 1.0


@pytest.mark.parametrize("cols,cf,acc", [(320, 0.05, 6), (320, 0.08, 4), (96, 0.1, 6),
                                         (33, 0.05, 4), (368, 0.04, 8)])
def test_random_mask_layout_matches(cols, cf, acc):
    """The centre band (``num_low`` columns from the JAX package's start) is
    always kept, by both, and under one key both draw the same mask."""
    assert tk.num_low_frequencies(cols, cf) == jk.num_low_frequencies(cols, cf)
    num_low = jk.num_low_frequencies(cols, cf)
    start = (cols - num_low + 1) // 2
    centre = np.zeros(cols, bool)
    centre[start : start + num_low] = True
    # an acceleration so high that nothing outside the band survives shows
    # the band itself: both frameworks give exactly it
    want = np.asarray(jk.random_mask(jax.random.key(0), cols, cf, 1e9))
    got = tk.random_mask(jr.key(0), cols, cf, 1e9)
    np.testing.assert_array_equal(want, centre)
    np.testing.assert_array_equal(got, centre)
    for seed in range(3):
        mask = tk.random_mask(jr.key(seed), cols, cf, acc)
        assert mask.dtype == bool and mask.shape == (cols,)
        assert mask[centre].all()
        np.testing.assert_array_equal(
            mask, np.asarray(jk.random_mask(jax.random.key(seed), cols, cf, acc)))


#: every (cf, acc) pair the protocol preprocesses (``configs/*.yaml``,
#: ``preprocessing.DEFAULT_MASKS``, ``results_run.ACC_MASKS``)
PROTOCOL_MASKS = ((0.05, 6), (0.05, 8), (0.1, 6), (0.2, 4))


@pytest.mark.parametrize("cols", [256, 320])
@pytest.mark.parametrize("cf,acc", PROTOCOL_MASKS)
def test_stem_masks_equal_the_jax_packages(cols, cf, acc):
    """200 stems: the mask under ``key(_stable_seed(stem, cf, acc))`` (the
    offline pipeline's and the online set's without remasking) equals the
    JAX package's, bit for bit."""
    stems = [f"file_brain_AXFLAIR_{i:06d}" for i in range(200)]
    draw = jax.jit(jax.vmap(lambda k: jk.random_mask(k, cols, cf, acc)))
    want = np.asarray(draw(jax.vmap(jax.random.key)(jnp.asarray(
        [jpre._stable_seed(s, cf, acc) for s in stems], jnp.uint32))))
    got = np.stack([tk.random_mask(jr.key(tpre._stable_seed(s, cf, acc)), cols, cf, acc)
                    for s in stems])
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("cols,cf,acc", [(320, 0.05, 6), (320, 0.08, 4)])
def test_random_mask_expected_fraction(cols, cf, acc):
    fracs = [tk.random_mask(jr.fold_in(jr.key(1), i), cols, cf, acc).mean()
             for i in range(200)]
    assert abs(np.mean(fracs) - 1 / acc) < 0.01


def test_undersample_volume_is_reproducible():
    k = torch.from_numpy(_kspace((2, 16, 40), seed=7))
    a, mask_a = tk.undersample_volume(k, jr.key(3), 0.1, 4)
    b, mask_b = tk.undersample_volume(k, jr.key(3), 0.1, 4)
    assert torch.equal(a, b) and (mask_a == mask_b).all()
    assert (a[..., ~mask_a] == 0).all()
    ri = torch.from_numpy(tk.to_ri(k.numpy()))
    c, mask_c = tk.undersample_volume_ri(ri, jr.key(3), 0.1, 4)
    assert (mask_c == mask_a).all()
    np.testing.assert_array_equal(torch.view_as_complex(c).numpy(), a.numpy())
    _, want = jk.undersample_volume(jnp.asarray(k.numpy()), jax.random.key(3), 0.1, 4)
    np.testing.assert_array_equal(mask_a, np.asarray(want))
