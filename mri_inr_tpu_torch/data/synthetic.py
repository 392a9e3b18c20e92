"""Synthetic phantom slices (own numpy copy of ``phantom_slice`` and
``phantom_volume`` from ``mri_inr_tpu/data/synthetic.py``): ellipse
"brain" magnitude images in [0, 1], optionally with band-limited texture.
Bit-identical to the JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np


def phantom_slice(rng: np.random.Generator, height: int, width: int,
                  num_ellipses: int = 8, texture: float = 0.0) -> np.ndarray:
    """One synthetic magnitude slice in [0, 1]."""
    yy, xx = np.mgrid[0:height, 0:width]
    yy = (yy - height / 2) / (height / 2)
    xx = (xx - width / 2) / (width / 2)
    img = np.zeros((height, width), np.float32)
    outer = ((yy / 0.9) ** 2 + (xx / 0.7) ** 2) < 1.0
    img += 0.35 * outer
    for _ in range(num_ellipses):
        cy, cx = rng.uniform(-0.5, 0.5, 2)
        ry, rx = rng.uniform(0.08, 0.4, 2)
        theta = rng.uniform(0, np.pi)
        amp = rng.uniform(-0.4, 0.6)
        yr = (yy - cy) * np.cos(theta) + (xx - cx) * np.sin(theta)
        xr = -(yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
        img += amp * (((yr / ry) ** 2 + (xr / rx) ** 2) < 1.0)
    if texture > 0.0:
        noise = rng.normal(size=(height, width))
        fy = np.fft.fftfreq(height)[:, None]
        fx = np.fft.fftfreq(width)[None, :]
        lp = np.exp(-((fy**2 + fx**2) / (2 * 0.06**2)))
        smooth = np.fft.ifft2(np.fft.fft2(noise) * lp).real
        smooth /= max(np.abs(smooth).max(), 1e-12)
        img += texture * smooth.astype(np.float32)
    img *= outer
    img -= img.min()
    if img.max() > 0:
        img /= img.max()
    return img.astype(np.float32)


def phantom_volume(seed: int, num_slices: int = 12, height: int = 320,
                   width: int = 320, texture: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([phantom_slice(rng, height, width, texture=texture)
                     for _ in range(num_slices)])
