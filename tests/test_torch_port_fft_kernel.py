"""The port's centred 2-D DFT (``mri_inr_tpu_torch/ops/fft_kernel.py``, a
mixed-radix FFT) against the JAX package's (dense DFT products, a Pallas
kernel run in interpret mode) on the same seeded inputs, and its 1-D radix
plans against numpy's FFT in float64.

Tolerance: float32 FFT against float32 dense products, atol 2e-5 on
unit-variance data (the JAX package's own bar against its FFT,
tests/test_fft_kernel.py); the round trip 3e-5; one plan's 1-D transform
against numpy's float64 FFT 1e-6 (float32 rounding over log n stages of
unit-variance data). On the CPU the wrapper takes the plain version and
counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.ops import fft_kernel as jfk
from mri_inr_tpu_torch.data import kspace as tk
from mri_inr_tpu_torch.ops import fft_kernel as tfk

torch.set_num_threads(1)

SHAPES = [(3, 64, 64), (3, 96, 64), (3, 63, 33), (2, 37, 41), (1, 48, 368)]


def _ri(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(*shape, 2)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 33, 37, 63, 320, 368, 640, 641])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_radix_plan_gives_the_centred_fft(n, inverse):
    plan = tfk.radices(n)
    assert int(np.prod(plan)) == n
    assert all(r in (2, 3, 4, 5, 8) or all(r % p for p in range(2, r)) for r in plan)
    rng = np.random.default_rng(n)
    v = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    re = torch.from_numpy(v.real.astype(np.float32))
    im = torch.from_numpy(v.imag.astype(np.float32))
    gr, gi = tfk._fft_last(re, im, inverse, shift_in=True)
    f = (np.fft.ifft if inverse else np.fft.fft)(np.fft.ifftshift(v, axes=-1), axis=-1,
                                                 norm="ortho")
    want = np.fft.fftshift(f, axes=-1)
    np.testing.assert_allclose(gr.numpy(), want.real, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gi.numpy(), want.imag, rtol=0, atol=1e-6)
    tab = tfk.tables(n, inverse, torch.device("cpu"))
    assert tab is tfk.tables(n, inverse, torch.device("cpu"))  # cached, not rebuilt
    assert tab.shape == (sum(r * ns + r for r, ns, _ in tfk._stages(n)), 2)


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
