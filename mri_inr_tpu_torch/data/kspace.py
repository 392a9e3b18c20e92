"""K-space pipeline: centred 2-D FFTs, undersampling masks, volume
normalisation (counterpart of ``mri_inr_tpu/data/kspace.py``).

- :func:`ifft2c` / :func:`fft2c`: centred orthonormal 2-D FFT,
  ``fftshift((i)fft2(ifftshift(x), norm="ortho"))`` over the last two dims.
- :func:`random_mask`: fastMRI ``RandomMaskFunc`` semantics, a per-column
  (phase-encode) mask: ``round(N * cf)`` central columns always kept, every
  other column kept independently with probability
  ``(N / acc - N * cf) / (N - N * cf)``.
- :func:`normalize_scan`: whole-volume min-max to [0, 1].

Plain functions on tensors through ``torch.fft``; they run wherever their
input lies. The mask draw takes a ``jax.random`` key's data (``(2,)``
uint32, :mod:`mri_inr_tpu_torch.utils.jax_random`) and draws the JAX
package's mask under that key, bit for bit.

Complex data also comes as float32 real/imag pairs ``(..., H, W, 2)`` (the
``*_ri`` functions), fastMRI's own layout and the DFT kernel's
(:mod:`mri_inr_tpu_torch.ops.fft_kernel`).
"""

from __future__ import annotations

import numpy as np
import torch

from mri_inr_tpu_torch.utils import jax_random


def _shifted_fft2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    dims = (-2, -1)
    x = torch.fft.ifftshift(x, dim=dims)
    x = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x, dim=dims, norm="ortho")
    return torch.fft.fftshift(x, dim=dims)


def ifft2c(kspace: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal inverse 2-D FFT over the last two dims."""
    return _shifted_fft2(kspace, inverse=True)


def fft2c(image: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal forward 2-D FFT over the last two dims."""
    return _shifted_fft2(image, inverse=False)


def complex_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def num_low_frequencies(num_cols: int, center_fraction: float) -> int:
    return round(num_cols * center_fraction)


def random_mask(key: np.ndarray, num_cols: int, center_fraction: float,
                acceleration: float) -> np.ndarray:
    """Boolean column mask of shape (num_cols,) under the ``jax.random``
    key ``key``. The expected retained fraction is 1/acceleration:
    ``num_low`` centre columns, starting at ``(num_cols - num_low + 1) //
    2``, are always kept; each other column is kept where its float32
    uniform lies below ``(num_cols / acceleration - num_low) / (num_cols -
    num_low)`` rounded to float32 (JAX compares a float32 array with a
    Python float in float32)."""
    num_low = num_low_frequencies(num_cols, center_fraction)
    prob = (num_cols / acceleration - num_low) / (num_cols - num_low)
    mask = jax_random.uniform(key, (num_cols,)) < np.float32(prob)
    pad = (num_cols - num_low + 1) // 2
    mask[pad : pad + num_low] = True
    return mask


def _as_mask(mask, like: torch.Tensor) -> torch.Tensor:
    real = like.real.dtype if like.is_complex() else like.dtype
    return torch.as_tensor(mask, device=like.device).to(real)


def apply_mask(kspace: torch.Tensor, mask) -> torch.Tensor:
    """Zero the unsampled phase-encode columns. ``mask`` is (W,) boolean and
    broadcasts over leading dims; columns are the last axis."""
    return kspace * _as_mask(mask, kspace)


def normalize_scan(volume: torch.Tensor) -> torch.Tensor:
    """Whole-volume min-max normalisation to [0, 1]."""
    lo, hi = volume.min(), volume.max()
    return (volume - lo) / (hi - lo)


def undersample_volume(kspace: torch.Tensor, key: np.ndarray, center_fraction: float,
                       acceleration: float) -> tuple[torch.Tensor, np.ndarray]:
    """Mask a (..., H, W) k-space volume with one random column mask (fastMRI
    draws one mask per volume). Returns (masked k-space, mask)."""
    mask = random_mask(key, kspace.shape[-1], center_fraction, acceleration)
    return apply_mask(kspace, mask), mask


def reconstruct_magnitude(kspace: torch.Tensor) -> torch.Tensor:
    """k-space -> image-space magnitude: ``ifft2c`` then ``complex_abs``."""
    return complex_abs(ifft2c(kspace))


def to_ri(kspace_complex) -> np.ndarray:
    """Host-side complex (..., H, W) -> float32 (..., H, W, 2) real/imag
    pairs."""
    k = np.asarray(kspace_complex)
    return np.stack([k.real, k.imag], axis=-1).astype(np.float32)


def reconstruct_magnitude_ri(kspace_ri: torch.Tensor) -> torch.Tensor:
    """float32 (..., H, W, 2) k-space -> (..., H, W) magnitude image."""
    return complex_abs(ifft2c(torch.view_as_complex(kspace_ri.contiguous())))


def apply_mask_ri(kspace_ri: torch.Tensor, mask) -> torch.Tensor:
    """Column mask on (..., H, W, 2) real/imag k-space: the mask runs over
    axis -2."""
    return kspace_ri * _as_mask(mask, kspace_ri)[:, None]


def undersample_volume_ri(kspace_ri: torch.Tensor, key: np.ndarray, center_fraction: float,
                          acceleration: float) -> tuple[torch.Tensor, np.ndarray]:
    mask = random_mask(key, kspace_ri.shape[-2], center_fraction, acceleration)
    return apply_mask_ri(kspace_ri, mask), mask
