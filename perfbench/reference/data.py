"""The data path of the reference: k-space -> undersampling mask -> centred
orthonormal inverse DFT -> magnitude -> whole-volume min-max -> 32x32 tiles
at stride 16 (reflect padding), the black-patch mask, the 24x24 target crop,
the radially weighted overlap-add of 24x24 outputs, and PSNR / SSIM / NRMSE
with skimage's defaults (joint data range, uniform 7x7 windows, sample
covariance, euclidean NRMSE). Plain ``torch`` in float32 (float64 where a
reduction is long).

Masks follow fastMRI's ``RandomMaskFunc``: ``round(W * cf)`` centre columns
kept, every other column kept where its uniform draw lies below ``(W / acc -
low) / (W - low)``; the draw is ``jax.random.uniform`` under ``key(crc32 of
"stem|cf|acc")``, with the mask epoch folded in where the data set remasks.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import threefry


def column_mask(stem: str, width: int, cf: float, acc: int, epoch: int | None) -> np.ndarray:
    k = threefry.key(zlib.crc32(f"{stem}|{float(cf)}|{int(acc)}".encode()))
    if epoch is not None:
        k = threefry.fold_in(k, epoch)
    low = round(width * cf)
    prob = np.float32((width / acc - low) / (width - low))
    mask = threefry.uniform(k, (width,)) < prob
    pad = (width - low + 1) // 2
    mask[pad : pad + low] = True
    return mask


def magnitude(kspace: torch.Tensor) -> torch.Tensor:
    """Complex (..., H, W) k-space -> |centred orthonormal inverse DFT|."""
    x = torch.fft.ifftshift(kspace, dim=(-2, -1))
    x = torch.fft.ifft2(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1)).abs()


def minmax(volume: torch.Tensor) -> torch.Tensor:
    """Min-max over the last three axes (a volume's slices together); a
    constant volume gives zeros."""
    lo = volume.amin(dim=(-3, -2, -1), keepdim=True)
    hi = volume.amax(dim=(-3, -2, -1), keepdim=True)
    return torch.where(hi > lo, (volume - lo) / (hi - lo), torch.zeros_like(volume))


def tiles(images: torch.Tensor, outer: int = 32, inner: int = 16) -> torch.Tensor:
    """(K, H, W) -> (K, nv * nh, outer, outer), row-major windows."""
    k, h, w = images.shape
    pad = (outer - inner) // 2
    vpad, hpad = (-h) % inner, (-w) % inner
    padded = F.pad(images[:, None], (pad, pad + hpad, pad, pad + vpad), mode="reflect")[:, 0]
    win = padded.unfold(1, outer, inner).unfold(2, outer, inner)
    return win.reshape(k, -1, outer, outer)


def valid_patches(patches: torch.Tensor) -> torch.Tensor:
    return patches.float().mean(dim=(-2, -1)) >= 1e-10


def centre(patches: torch.Tensor, outer: int = 32, size: int = 24) -> torch.Tensor:
    s = (outer - size) // 2
    return patches[..., s : s + size, s : s + size]


def _blend(size: int) -> torch.Tensor:
    c = (size - 1) / 2
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    w = np.exp(-0.1 * np.sqrt((ii - c) ** 2 + (jj - c) ** 2))
    return torch.from_numpy(w / w.max())


def weighted_fold(patches: torch.Tensor, grid: tuple[int, int], inner: int = 16
                  ) -> torch.Tensor:
    """(K, nv*nh, s, s) outputs -> (K, nv*inner, nh*inner) images: each
    patch centred on its inner block, weighted, summed and divided by the
    summed weights (float64 sums)."""
    k, n, s, _ = patches.shape
    nv, nh = grid
    pad = (s - inner) // 2
    w = _blend(s).to(patches.device)
    num = torch.zeros(k, nv * inner + 2 * pad, nh * inner + 2 * pad, dtype=torch.float64,
                      device=patches.device)
    den = torch.zeros_like(num[0])
    p = patches.double().reshape(k, nv, nh, s, s)
    for r in range(nv):
        for c in range(nh):
            num[:, r * inner : r * inner + s, c * inner : c * inner + s] += p[:, r, c] * w
            den[r * inner : r * inner + s, c * inner : c * inner + s] += w
    out = num / den
    return out[:, pad : pad + nv * inner, pad : pad + nh * inner]


def _window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    return F.avg_pool2d(x[:, None], win, stride=1)[:, 0]


def image_metrics(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(K, H, W) pairs -> (3, K) float64 rows of PSNR, SSIM, NRMSE."""
    gt, pred = gt.double(), pred.double()
    lo = torch.minimum(gt.amin((-2, -1)), pred.amin((-2, -1)))
    hi = torch.maximum(gt.amax((-2, -1)), pred.amax((-2, -1)))
    rng = hi - lo
    mse = torch.mean((gt - pred) ** 2, (-2, -1))
    psnr = 10.0 * torch.log10(rng**2 / mse)
    win = 7
    ux, uy = _window_mean(gt, win), _window_mean(pred, win)
    uxx, uyy, uxy = (_window_mean(a, win) for a in (gt * gt, pred * pred, gt * pred))
    norm = win * win / (win * win - 1.0)
    vx, vy, vxy = norm * (uxx - ux * ux), norm * (uyy - uy * uy), norm * (uxy - ux * uy)
    c1 = ((0.01 * rng) ** 2)[:, None, None]
    c2 = ((0.03 * rng) ** 2)[:, None, None]
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    ssim = s.mean((-2, -1))
    nrmse = torch.sqrt(mse) / torch.sqrt(torch.mean(gt**2, (-2, -1)))
    return torch.stack([psnr, ssim, nrmse])


def grid_of(height: int, width: int, inner: int = 16) -> tuple[int, int]:
    return math.ceil(height / inner), math.ceil(width / inner)
