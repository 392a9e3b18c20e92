"""The plain reference's pieces against the program's at small sizes on the
CPU: the draws, the masks, the dropout hash, the reconstruction, the tiles,
the fold and the metrics. (The reference itself imports nothing of the
program; only this test holds the two side by side.)"""

import numpy as np
import pytest
import torch

from mri_inr_tpu_torch.data import kspace, preprocessing
from mri_inr_tpu_torch.eval import metrics
from mri_inr_tpu_torch.ops import siren_train_kernel as stk
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.utils import jax_random
from perfbench.core import phantom
from perfbench.reference import data, threefry, train


def test_draws_and_masks():
    k = jax_random.key(2**31 + 7)
    assert (threefry.fold_in(k, np.arange(9)) == jax_random.fold_in(k, np.arange(9))).all()
    assert (threefry.uniform(k, (64,)) == jax_random.uniform(k, (64,))).all()
    keys = jax_random.fold_in(k, np.arange(5))
    assert (threefry.randint(keys, 0, 2**23) == jax_random.randint(keys, (), 0, 2**23)).all()
    for epoch in (None, 0, 3):
        key = jax_random.key(preprocessing._stable_seed("vol_a", 0.05, 6))
        if epoch is not None:
            key = jax_random.fold_in(key, epoch)
        assert (data.column_mask("vol_a", 96, 0.05, 6, epoch)
                == kspace.random_mask(key, 96, 0.05, 6)).all()


@pytest.mark.parametrize("layer", [0, 3])
def test_hash_dropout(layer):
    seed = 4_000_001
    want = stk.dropout_mask(torch.tensor([float(seed)]), layer, 0.9, (6, 9, 8))
    got = train.hash_drop(seed, 0.9, 0, 9, 8)(torch.ones(6, 9, 8), layer)
    assert torch.equal(got, want)
    part = train.hash_drop(seed, 0.9, 2, 9, 8)(torch.ones(3, 9, 8), layer)
    assert torch.equal(part, want[2:5])


def test_images_tiles_fold_metrics():
    gen = phantom.generator(11, "cpu")
    k = phantom.volumes(2, 3, 48, gen)
    img = data.minmax(data.magnitude(k[0]))
    port = kspace.reconstruct_magnitude_ri(torch.from_numpy(kspace.to_ri(k[0].numpy())))
    port = (port - port.min()) / (port.max() - port.min())
    assert torch.allclose(img, port, atol=1e-6)
    assert torch.equal(data.tiles(img), tiling.image_to_patches(img, 32, 16))
    out = torch.rand(3, 9, 24, 24, generator=torch.Generator().manual_seed(0))
    grid = data.grid_of(48, 48)
    want = tiling.patches_to_image_weighted_average(out, grid, 24, 16)
    assert torch.allclose(data.weighted_fold(out, grid).float(), want, atol=1e-5)
    m = metrics.image_metrics(img, want)
    got = data.image_metrics(img, want)
    for i, name in enumerate(("psnr", "ssim", "nrmse")):
        assert torch.allclose(got[i].float(), m[name].float(), rtol=1e-4)
