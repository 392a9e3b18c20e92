"""PSNR / SSIM / NRMSE (counterpart of ``mri_inr_tpu/eval/metrics.py``).

The reference's semantics (skimage defaults): the joint data range
``max(a.max(), b.max()) - min(a.min(), b.min())`` for PSNR and SSIM; SSIM
with uniform 7x7 windows, K1 0.01, K2 0.03, sample covariance 49/48, the
border cropped (here: VALID windows, which is equivalent); NRMSE with the
euclidean normalisation ``sqrt(mse) / sqrt(mean(gt**2))``. Results are 0-d
tensors on the input's device, so a sweep can keep them there. A stack of K
image pairs, (K, H, W), is scored per image: every reduction (data range,
means) runs over the last two dimensions, and the results have shape (K,).
"""

from __future__ import annotations

import torch


_IMAGE = (-2, -1)


def joint_data_range(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return (torch.maximum(gt.amax(_IMAGE), pred.amax(_IMAGE))
            - torch.minimum(gt.amin(_IMAGE), pred.amin(_IMAGE)))

def psnr(gt: torch.Tensor, pred: torch.Tensor,
         data_range: torch.Tensor | None = None) -> torch.Tensor:
    if data_range is None:
        data_range = joint_data_range(gt, pred)
    mse = torch.mean(torch.square(gt - pred), _IMAGE)
    return 10.0 * torch.log10(torch.square(data_range) / mse)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over each VALID win x win window of the last two dimensions: a
    row pass of window sums, then a column pass."""
    rows = x.unfold(-2, win, 1).sum(-1)
    return rows.unfold(-1, win, 1).sum(-1) / (win * win)


def ssim(gt: torch.Tensor, pred: torch.Tensor,
         data_range: torch.Tensor | None = None, win_size: int = 7) -> torch.Tensor:
    """Mean structural similarity over a 2-D image pair (or per pair of a
    stack)."""
    if data_range is None:
        data_range = joint_data_range(gt, pred)
    x = gt.float()
    y = pred.float()
    ux = _uniform_filter_valid(x, win_size)
    uy = _uniform_filter_valid(y, win_size)
    uxx = _uniform_filter_valid(x * x, win_size)
    uyy = _uniform_filter_valid(y * y, win_size)
    uxy = _uniform_filter_valid(x * y, win_size)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    # a per-image constant, broadcast over the image's two dimensions
    c1 = torch.square(0.01 * data_range)[..., None, None]
    c2 = torch.square(0.03 * data_range)[..., None, None]
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2), _IMAGE)


def nrmse(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(gt - pred), _IMAGE)
    return torch.sqrt(mse) / torch.sqrt(torch.mean(torch.square(gt), _IMAGE))


def image_metrics(gt: torch.Tensor, pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """PSNR / SSIM / NRMSE of one image pair (or per pair of a stack), joint
    data range."""
    dr = joint_data_range(gt, pred)
    return {"psnr": psnr(gt, pred, dr), "ssim": ssim(gt, pred, dr),
            "nrmse": nrmse(gt, pred)}
