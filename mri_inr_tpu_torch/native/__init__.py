"""Host-side tile helpers (counterpart of ``mri_inr_tpu/native/__init__.py``).

The JAX package builds ``tileops.cpp`` (C++/OpenMP) for these and keeps numpy
versions that its tests hold exact-equal to the native ones. The port carries
the numpy versions only; the native build is queued in ``ROADMAP.md``.

- ``tile_image(image, outer, inner)`` -> (nv*nh, outer, outer), (nv, nh)
- ``gather_pairs(fully, under, idx)`` -> (batch_fully, batch_under)
- ``patch_means(patches)`` -> (n,) means (black-patch classification)
"""

from __future__ import annotations

import numpy as np


def tile_image(image: np.ndarray, outer: int, inner: int):
    """Reflect-pad + overlapping-window extraction of one (H, W) image.
    Returns ((nv*nh, outer, outer) float32, (nv, nh))."""
    image = np.ascontiguousarray(image, np.float32)
    height, width = image.shape
    pad = (outer - inner) // 2
    vpad = (inner - height % inner) % inner
    hpad = (inner - width % inner) % inner
    padded = np.pad(image, ((pad, pad + vpad), (pad, pad + hpad)), mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (outer, outer))[
        ::inner, ::inner
    ]
    nv, nh = windows.shape[:2]
    return windows.reshape(nv * nh, outer, outer).copy(), (nv, nh)


def gather_pairs(fully: np.ndarray, under: np.ndarray, idx: np.ndarray):
    """Rows ``idx`` of two parallel (N, P, P) pools as fresh arrays."""
    return fully[idx], under[idx]


def patch_means(patches: np.ndarray) -> np.ndarray:
    """Per-patch mean over a (N, P, P) float32 pool (summed in f64)."""
    return patches.mean(axis=(-2, -1), dtype=np.float64).astype(np.float32)
