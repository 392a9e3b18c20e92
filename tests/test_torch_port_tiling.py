"""The port's tiling against the JAX package's: patches bit for bit, folds
within 1e-6 (the same sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.ops import tiling as jt
from mri_inr_tpu_torch.ops import tiling as tt

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

SHAPES = [(320, 320), (100, 77)]


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_patches_bit_for_bit(shape):
    img = _image(shape)
    want = np.asarray(jt.image_to_patches(jnp.asarray(img), 32, 16))
    got = tt.image_to_patches(torch.from_numpy(img), 32, 16).numpy()
    assert tt.grid_shape(*shape, 16) == jt.grid_shape(*shape, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_weighted_fold(shape):
    grid = jt.grid_shape(*shape, 16)
    patches = np.random.default_rng(1).uniform(
        size=(grid[0] * grid[1], 24, 24)).astype(np.float32)
    want = np.asarray(jt.patches_to_image_weighted_average(jnp.asarray(patches), grid, 24, 16))
    got = tt.patches_to_image_weighted_average(torch.from_numpy(patches), grid, 24, 16).numpy()
    assert got.shape == (grid[0] * 16, grid[1] * 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fold_reproduces_the_image(shape):
    img = _image(shape)
    grid = jt.grid_shape(*shape, 16)
    patches = tt.image_to_patches(torch.from_numpy(img), 32, 16)
    want = np.asarray(jt.patches_to_image(jnp.asarray(patches.numpy()), grid, 32, 16))
    got = tt.patches_to_image(patches, grid, 32, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[: shape[0], : shape[1]], img, rtol=0, atol=1e-6)


def test_weight_matrix_and_center_crop():
    np.testing.assert_array_equal(tt.generate_weight_matrix(24).numpy(),
                                  np.asarray(jt.generate_weight_matrix(24)))
    p = np.random.default_rng(2).uniform(size=(5, 32, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tt.extract_center_batch(torch.from_numpy(p), 32, 24).numpy(),
        np.asarray(jt.extract_center_batch(jnp.asarray(p), 32, 24)))


def test_black_patch_mask_still_counts_in_the_denominator():
    img = _image((96, 96))
    img[:40] = 0.0  # black band: the top patch rows are black
    patches = tt.image_to_patches(torch.from_numpy(img), 32, 16)
    valid = tt.classify_black_patches(patches)
    want_valid = np.asarray(jt.classify_black_patches(jnp.asarray(patches.numpy())))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert 0 < int(valid.sum()) < valid.numel()
    values = torch.ones(patches.shape[0], 24, 24)
    masked = tt.mask_black_patches(values, valid)
    np.testing.assert_array_equal(
        masked.numpy(),
        np.asarray(jt.mask_black_patches(jnp.ones((patches.shape[0], 24, 24)),
                                         jnp.asarray(want_valid))))
    recon = tt.patches_to_image_weighted_average(masked, (6, 6), 24, 16)
    assert recon[0, 0] == 0.0 and recon[-1, -1] == pytest.approx(1.0)


def test_odd_padding_is_rejected():
    with pytest.raises(ValueError, match="even"):
        tt.image_to_patches(torch.zeros(64, 64), 31, 16)
