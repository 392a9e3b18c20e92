"""Synthetic fastMRI-like data (own numpy copy of
``mri_inr_tpu/data/synthetic.py``): ellipse "brain" magnitude volumes in
[0, 1], optionally with band-limited texture, their centred k-space with
optional smooth phase maps and measurement noise, and ``.h5`` files in the
fastMRI layout (a ``kspace`` dataset of shape (S, H, W)), so preprocessing ->
dataset -> train -> eval runs without the fastMRI download. Bit-identical to
the JAX package's for the same seeds.
"""

from __future__ import annotations

import pathlib

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


def random_phase_map(rng: np.random.Generator, height: int, width: int,
                     components: int = 4) -> np.ndarray:
    """Smooth low-frequency phase map in radians (a sum of random 2-D
    cosines, at most ~2 cycles across the field of view). With a phase the
    masked k-space loses conjugate symmetry, as real single-coil data does."""
    yy, xx = np.mgrid[0:height, 0:width]
    yy = yy / height
    xx = xx / width
    phi = np.zeros((height, width))
    for _ in range(components):
        fy, fx = rng.uniform(-2.0, 2.0, 2)
        amp = rng.uniform(0.4, 1.6)
        phi += amp * np.cos(2 * np.pi * (fy * yy + fx * xx)
                            + rng.uniform(0, 2 * np.pi))
    return phi.astype(np.float32)


def volume_to_kspace(volume: np.ndarray, phase: np.ndarray | None = None,
                     noise_rng: np.random.Generator | None = None,
                     snr_db: float | None = None) -> np.ndarray:
    """Image-space magnitude volume -> centred complex64 k-space (``fft2c``
    semantics, on the host).

    ``phase``: per-slice (S, H, W) radian maps multiplied in as
    ``exp(i * phase)`` before the FFT. ``snr_db`` (+ ``noise_rng``): complex
    white Gaussian noise in k-space at that SNR relative to the k-space RMS
    signal."""
    img = volume.astype(np.complex64)
    if phase is not None:
        img = img * np.exp(1j * phase.astype(np.float32))
    shifted = np.fft.ifftshift(img, axes=(-2, -1))
    k = np.fft.fft2(shifted, axes=(-2, -1), norm="ortho")
    k = np.fft.fftshift(k, axes=(-2, -1)).astype(np.complex64)
    if snr_db is not None:
        if noise_rng is None:
            noise_rng = np.random.default_rng(0)
        rms = np.sqrt(np.mean(np.abs(k) ** 2))
        # a float32 sigma: a float64 scalar would promote the sum to
        # complex128 under NumPy 2 and break the complex64 layout
        sigma = np.float32(rms / (10.0 ** (snr_db / 20.0)) / np.sqrt(2.0))
        k = (k + sigma * (
            noise_rng.normal(size=k.shape) + 1j * noise_rng.normal(size=k.shape)
        ).astype(np.complex64)).astype(np.complex64)
    return k


def synthetic_stem(index: int) -> str:
    """File stem of synthetic volume ``index`` (a FLAIR brain fastMRI name,
    so the filename metadata parser applies)."""
    return f"file_brain_AXFLAIR_{index:06d}"


def synthetic_kspace(index: int, num_slices: int = 12, height: int = 320,
                     width: int = 320, phase: bool = False,
                     snr_db: float | None = None, texture: float = 0.0) -> np.ndarray:
    """The k-space :func:`write_synthetic_h5` writes for volume ``index``
    (= seed + file number)."""
    vol = phantom_volume(index, num_slices, height, width, texture=texture)
    rng = np.random.default_rng(10_000_019 * index + 7)
    phase_maps = (np.stack([random_phase_map(rng, height, width)
                            for _ in range(num_slices)]) if phase else None)
    return volume_to_kspace(vol, phase=phase_maps,
                            noise_rng=rng if snr_db is not None else None, snr_db=snr_db)


def write_synthetic_h5(directory: str | pathlib.Path, num_files: int = 3,
                       num_slices: int = 12, height: int = 320, width: int = 320,
                       seed: int = 0, phase: bool = False, snr_db: float | None = None,
                       texture: float = 0.0) -> list[pathlib.Path]:
    """Write fastMRI-layout ``.h5`` files. The defaults give smooth
    real-valued phantoms; ``phase`` + ``snr_db`` + ``texture`` are the hard
    mode (complex phase, k-space noise, tissue-like texture)."""
    import h5py

    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(num_files):
        k = synthetic_kspace(seed + i, num_slices, height, width, phase=phase,
                             snr_db=snr_db, texture=texture)
        path = directory / f"{synthetic_stem(seed + i)}.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset("kspace", data=k)
        paths.append(path)
    return paths
