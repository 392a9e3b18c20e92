"""Training losses (counterpart of ``mri_inr_tpu/train/losses.py``).

- ``mse``: mean squared error.
- ``edge_loss``: ``MSE(x, y) + 0.5 * (MSE(Gx(x), Gx(y)) + MSE(Gy(x), Gy(y)))``
  with the 3x3 Sobel kernels ``[[1,0,-1],[2,0,-2],[1,0,-1]]`` (x) and its
  transpose (y), zero ("SAME") padding, written as shifted adds over a padded
  copy (the separable form ``[1,2,1]^T x [1,0,-1]``), as the JAX package
  writes it.
- ``perceptual``: the MSE between the features of a frozen pretrained
  :class:`~mri_inr_tpu_torch.models.perceptual.PerceptualEncoderV2` (eval
  mode, running statistics) of prediction and target. No gradient reaches
  the encoder's weights; it flows through the encoder to the prediction.

All losses take (pred, target) of shape (B, H, W) and return a scalar.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from mri_inr_tpu_torch.models.perceptual import PerceptualEncoderV2


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


def make_perceptual_loss(encoder_state: Mapping[str, torch.Tensor], img_size: int = 24,
                         device: str | torch.device = "cpu"):
    """A perceptual loss over a frozen encoder on ``device``:
    ``encoder_state`` is a :class:`PerceptualEncoderV2` state dict with its
    running statistics (what ``train_encoder --model perceptual`` saves),
    loaded strictly; its latent width is read from the state.
    ``loss.encoder`` is the frozen module."""
    encoder = PerceptualEncoderV2(img_size=img_size,
                                  latent_dim=encoder_state["fc_block.fc.weight"].shape[0])
    encoder.load_state_dict(encoder_state, strict=True)
    encoder.to(device).eval().requires_grad_(False)

    def loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return mse(encoder(pred), encoder(target))

    loss.encoder = encoder
    return loss


def make_loss_fn(criterion: str, perceptual_state: Mapping[str, torch.Tensor] | None = None,
                 img_size: int = 24, device: str | torch.device = "cpu"):
    """A canonical criterion name (``configuration.CRITERIA``) -> a
    (pred, target) -> scalar function. ``perceptual`` needs the pretrained
    encoder's state dict (``training.perceptual_encoder_path``) and runs it
    on ``device``."""
    if criterion == "mse":
        return mse
    if criterion == "edge":
        return edge_loss
    if criterion == "perceptual":
        if perceptual_state is None:
            raise ValueError(
                "criterion='perceptual' requires pretrained perceptual-encoder "
                "weights (training.perceptual_encoder_path)")
        return make_perceptual_loss(perceptual_state, img_size, device)
    raise ValueError(f"Unknown criterion {criterion!r}")
