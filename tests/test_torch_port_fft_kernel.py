"""The port's DFT module (``mri_inr_tpu_torch/ops/fft_kernel.py``) against
the JAX package's: the transform matrices bit for bit, and the plain PyTorch
version of the CUDA kernel against the Pallas kernel in interpret mode on
the same seeded inputs.

Tolerance: both multiply the same float32 matrices and sum in float32 in
another order, atol 2e-5 on unit-variance data (the JAX package's own bar
against its FFT, tests/test_fft_kernel.py); the round trip 3e-5. On the CPU
the wrapper takes the plain version and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.ops import fft_kernel as jfk
from mri_inr_tpu_torch.data import kspace as tk
from mri_inr_tpu_torch.ops import fft_kernel as tfk

torch.set_num_threads(1)

SHAPES = [(3, 64, 64), (3, 96, 64), (3, 63, 33)]


def _ri(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(*shape, 2)).astype(np.float32)


@pytest.mark.parametrize("n", [64, 63, 33, 320])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_matrices_are_bit_identical(n, inverse):
    want = jfk._centered_dft_matrix_np(n, inverse)
    got = tfk._centered_dft_matrix_np(n, inverse)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    re, im = tfk._matrices(n, inverse, torch.device("cpu"))
    np.testing.assert_array_equal(re.numpy(), want[0])
    assert tfk._matrices(n, inverse, torch.device("cpu"))[0] is re  # cached, not rebuilt
    ri = tfk._matrix_ri(n, inverse, True, torch.device("cpu"))
    np.testing.assert_array_equal(ri[..., 0].numpy(), want[0].T)
    np.testing.assert_array_equal(ri[..., 1].numpy(), want[1].T)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex", "magnitude"])
def test_plain_version_matches_pallas_interpret(shape, inverse, magnitude):
    x = _ri(shape, seed=1)
    want = np.asarray(jfk.dft2c_ri(jnp.asarray(x), inverse=inverse, magnitude=magnitude,
                                   interpret=True))
    before = tfk.dft2c_ri_cuda.launches
    got = tfk.dft2c_ri(torch.from_numpy(x), inverse=inverse, magnitude=magnitude).numpy()
    assert tfk.dft2c_ri_cuda.launches == before  # CPU: plain version
    assert got.shape == want.shape == (shape if magnitude else (*shape, 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_matches_torch_fft(shape):
    x = torch.from_numpy(_ri(shape, seed=2))
    c = torch.view_as_complex(x)
    np.testing.assert_allclose(torch.view_as_complex(tfk.dft2c_ri(x)).numpy(),
                               tk.ifft2c(c).numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(torch.view_as_complex(tfk.dft2c_ri(x, inverse=False)).numpy(),
                               tk.fft2c(c).numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tfk.reconstruct_magnitude_ri_dft(x).numpy(),
                               tk.reconstruct_magnitude_ri(x).numpy(), rtol=0, atol=2e-5)


def test_round_trip_and_leading_dims():
    x = torch.from_numpy(_ri((2, 2, 64, 48), seed=3))
    img = tfk.dft2c_ri(x, inverse=True)
    assert img.shape == (2, 2, 64, 48, 2)
    np.testing.assert_allclose(tfk.dft2c_ri(img, inverse=False).numpy(), x.numpy(),
                               rtol=0, atol=3e-5)
    assert tfk.dft2c_ri(x[0, 0], magnitude=True).shape == (64, 48)
    np.testing.assert_array_equal(tfk.dft2c_ri(x, magnitude=True)[1, 0].numpy(),
                                  tfk.dft2c_ri(x[1, 0], magnitude=True).numpy())


def test_wrapper_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dft2c_ri_cuda(torch.zeros(1, 8, 8, 2))
    with pytest.raises(ValueError, match="real/imag"):
        tfk.dft2c_ri(torch.zeros(1, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        tfk.dft2c_ri(torch.zeros(1, 8, 8, 2, dtype=torch.float64))
