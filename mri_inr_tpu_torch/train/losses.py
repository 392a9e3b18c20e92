"""Training losses (counterpart of ``mri_inr_tpu/train/losses.py``).

- ``mse``: mean squared error.
- ``edge_loss``: ``MSE(x, y) + 0.5 * (MSE(Gx(x), Gx(y)) + MSE(Gy(x), Gy(y)))``
  with the 3x3 Sobel kernels ``[[1,0,-1],[2,0,-2],[1,0,-1]]`` (x) and its
  transpose (y), zero ("SAME") padding, written as shifted adds over a padded
  copy (the separable form ``[1,2,1]^T x [1,0,-1]``), as the JAX package
  writes it.
- ``perceptual``: not ported yet (it needs the perceptual encoder).

All losses take (pred, target) of shape (B, H, W) and return a scalar.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def _sobel_maps(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both Sobel maps of a (B, H, W) batch, each (B, H, W), identical to a
    zero-padded 3x3 correlation."""
    p = F.pad(images, (1, 1, 1, 1))
    s = p[:, :-2, :] + 2.0 * p[:, 1:-1, :] + p[:, 2:, :]  # vertical [1,2,1]
    t = p[:, :, :-2] + 2.0 * p[:, :, 1:-1] + p[:, :, 2:]  # horizontal [1,2,1]
    gx = s[:, :, :-2] - s[:, :, 2:]
    gy = t[:, :-2, :] - t[:, 2:, :]
    return gx, gy


def edge_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    px, py = _sobel_maps(pred)
    tx, ty = _sobel_maps(target)
    return mse(pred, target) + 0.5 * (mse(px, tx) + mse(py, ty))


def make_loss_fn(criterion: str):
    """A canonical criterion name (``configuration.CRITERIA``) -> a
    (pred, target) -> scalar function."""
    if criterion == "mse":
        return mse
    if criterion == "edge":
        return edge_loss
    if criterion == "perceptual":
        raise NotImplementedError(
            "criterion=perceptual is not ported yet (ROADMAP queue 1, item 15, "
            "'VGG and perceptual ablations')"
        )
    raise ValueError(f"Unknown criterion {criterion!r}")
