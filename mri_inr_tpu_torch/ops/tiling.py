"""Patch extraction and overlap-add recomposition (counterpart of
``mri_inr_tpu/ops/tiling.py``). Defaults ``outer=32, inner=16, siren=24``.

- extraction: reflect-pad by ``(outer-inner)/2`` on all sides plus
  bottom/right padding to a multiple of ``inner``; ``outer``-sized windows
  at stride ``inner``, row-major. One path for every geometry (the JAX
  package's block/gather split at ``tiling.py:67`` is not carried over); an
  odd ``outer - inner`` has no centred padding and is rejected.
- weighted recomposition: radial weights ``exp(-0.1 * dist)`` normalised to
  max 1, folded with ``kernel=siren, stride=inner, padding=(siren-inner)/2``
  and divided by the folded weights. The denominator depends on the geometry
  only, so it is computed once per geometry on the host and kept on the
  device.
- plain recomposition: fold with ``kernel=outer``, ones normalisation.
- black patches (``mean < 1e-10``) are a validity mask: a masked patch is
  zeroed but still counts in the denominator.

Extraction and the folds take one image, or a stack of K images of one
shape with a leading K dimension: (K, H, W) -> (K, n, outer, outer) and
(K, n, s, s) -> (K, nv*inner, nh*inner); a stack runs as one batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

BLACK_PATCH_THRESHOLD = 1e-10


def grid_shape(height: int, width: int, inner_patch_size: int) -> tuple[int, int]:
    """Number of (vertical, horizontal) patches for an image."""
    return -(-height // inner_patch_size), -(-width // inner_patch_size)


def image_to_patches(image: torch.Tensor, outer_patch_size: int,
                     inner_patch_size: int) -> torch.Tensor:
    """(H, W) image -> (nv * nh, outer, outer) patches, row-major; a (K, H, W)
    stack -> (K, nv * nh, outer, outer)."""
    if (outer_patch_size - inner_patch_size) % 2:
        raise ValueError(
            f"outer - inner must be even for centred padding, got "
            f"{outer_patch_size} - {inner_patch_size}"
        )
    height, width = image.shape[-2:]
    pad = (outer_patch_size - inner_patch_size) // 2
    vpad = (inner_patch_size - height % inner_patch_size) % inner_patch_size
    hpad = (inner_patch_size - width % inner_patch_size) % inner_patch_size
    # F.pad's reflect mode takes a batched (N, C, H, W) input
    stack = image.reshape(-1, 1, height, width)
    padded = F.pad(stack, (pad, pad + hpad, pad, pad + vpad), mode="reflect")[:, 0]
    windows = padded.unfold(1, outer_patch_size, inner_patch_size).unfold(
        2, outer_patch_size, inner_patch_size)
    return windows.reshape(*image.shape[:-2], -1, outer_patch_size, outer_patch_size)


@functools.lru_cache(maxsize=None)
def _weight_matrix_np(tile_size: int) -> np.ndarray:
    center = (tile_size - 1) / 2
    ii, jj = np.meshgrid(np.arange(tile_size), np.arange(tile_size), indexing="ij")
    w = np.exp(-0.1 * np.sqrt((ii - center) ** 2 + (jj - center) ** 2))
    return (w / w.max()).astype(np.float32)


def generate_weight_matrix(tile_size: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Radial overlap-blending weights, max-normalised to 1."""
    return torch.from_numpy(_weight_matrix_np(tile_size)).to(device)


@functools.lru_cache(maxsize=None)
def _weight_matrix_on(tile_size: int, device: torch.device) -> torch.Tensor:
    """:func:`generate_weight_matrix`, made once per (size, device): an
    upload from host memory on every fold would make the host wait for the
    device's stream."""
    return generate_weight_matrix(tile_size, device)


def _fold(patches: torch.Tensor, grid: tuple[int, int], kernel: int,
          stride: int) -> torch.Tensor:
    """Overlap-add of (..., nv*nh, kernel, kernel) patches into
    (..., nv*s, nh*s): block (r, c) covers rows ``r*stride - pad .. + kernel``
    with ``pad = (kernel - stride) // 2``; out-of-bounds parts are dropped."""
    nv, nh = grid
    lead = patches.shape[:-3]
    cols = patches.reshape(-1, nv * nh, kernel * kernel).transpose(1, 2)
    out = F.fold(cols, (nv * stride, nh * stride), kernel, stride=stride,
                 padding=(kernel - stride) // 2)
    return out.reshape(*lead, nv * stride, nh * stride)


@functools.lru_cache(maxsize=None)
def _fold_den(grid: tuple[int, int], kernel: int, stride: int, weighted: bool,
              device: torch.device) -> torch.Tensor:
    """The fold's denominator: a function of the geometry alone."""
    nv, nh = grid
    tile = _weight_matrix_np(kernel) if weighted else np.ones((kernel, kernel), np.float32)
    pad = (kernel - stride) // 2
    out_h, out_w = nv * stride, nh * stride
    canvas = np.zeros((out_h + 2 * pad, out_w + 2 * pad), np.float64)
    for r in range(nv):
        for c in range(nh):
            canvas[r * stride : r * stride + kernel, c * stride : c * stride + kernel] += tile
    den = canvas[pad : pad + out_h, pad : pad + out_w].astype(np.float32)
    return torch.from_numpy(den).to(device)


def patches_to_image_weighted_average(patches: torch.Tensor, grid: tuple[int, int],
                                      siren_patch_size: int,
                                      inner_patch_size: int) -> torch.Tensor:
    """Blend (N, siren, siren) model outputs into a (nv*inner, nh*inner)
    image with radial weights; (K, N, siren, siren) into K images."""
    weights = _weight_matrix_on(siren_patch_size, patches.device)
    num = _fold(patches * weights, grid, siren_patch_size, inner_patch_size)
    return num / _fold_den(grid, siren_patch_size, inner_patch_size, True,
                           patches.device)


def patches_to_image(patches: torch.Tensor, grid: tuple[int, int],
                     outer_patch_size: int, inner_patch_size: int) -> torch.Tensor:
    """Uniform-average recomposition of (N, outer, outer) patches; of
    (K, N, outer, outer) into K images."""
    num = _fold(patches, grid, outer_patch_size, inner_patch_size)
    return num / _fold_den(grid, outer_patch_size, inner_patch_size, False,
                           patches.device)


def extract_center_batch(patches: torch.Tensor, outer_patch_size: int,
                         center_size: int) -> torch.Tensor:
    """Centre-crop (N, outer, outer) -> (N, center, center)."""
    start = (outer_patch_size - center_size) // 2
    return patches[..., start : start + center_size, start : start + center_size]


def classify_black_patches(patches: torch.Tensor) -> torch.Tensor:
    """True for informative patches, False for black (mean < 1e-10) ones."""
    return patches.mean(dim=(-2, -1)) >= BLACK_PATCH_THRESHOLD


def mask_black_patches(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero the entries of (N, ...) ``values`` whose patch is black; ``valid``
    is (N,), or (K, N) for (K, N, ...) values."""
    return values * valid.reshape(valid.shape + (1,) * (values.ndim - valid.ndim)).to(
        values.dtype)
