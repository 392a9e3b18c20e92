"""Patch encoders (counterpart of ``mri_inr_tpu/models/encoder.py``).

``ConvEncoder`` is the ``custom`` latent encoder: Conv(1->16, k3, s2, p1) ->
LeakyReLU(0.2) -> Conv(16->32, k3, s2, p1) -> LeakyReLU -> Conv(32->64, k8,
valid) -> LeakyReLU -> flatten -> Linear(-> latent). Flax's
``Conv(k3, s2, padding=((1, 1), (1, 1)))`` is ``Conv2d(stride=2,
padding=1)``. The JAX package computes in NHWC; here the convolutions run in
NCHW and the feature map is put back in NHWC order before the flatten, so
the ``fc`` weight maps one to one for any patch size (at 32x32 the map is
1x1 and both orders agree anyway).

Conv and Dense layers take Flax's default init (lecun-normal, zero bias),
not torch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mri_inr_tpu_torch.models.siren import dense, lecun_normal_init, linear


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          generator: torch.Generator | None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)
    lecun_normal_init(conv.weight, cin * kernel * kernel, generator)
    nn.init.zeros_(conv.bias)
    return conv


class ConvEncoder(nn.Module):
    """The ``custom`` patch encoder: (B, P, P) -> (B, latent_dim)."""

    def __init__(self, latent_dim: int = 256, patch_size: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(1, 16, 3, 2, 1, generator)
        self.conv2 = _conv(16, 32, 3, 2, 1, generator)
        self.conv3 = _conv(32, 64, 8, 1, 0, generator)
        side = (patch_size + 1) // 2
        side = (side + 1) // 2 - 7
        self.fc = dense(64 * side * side, latent_dim, generator)

    def _apply_conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                        stride=conv.stride, padding=conv.padding)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches.to(self.compute_dtype)[:, None]  # NCHW
        x = leaky_relu(self._apply_conv(x, self.conv1))
        x = leaky_relu(self._apply_conv(x, self.conv2))
        x = leaky_relu(self._apply_conv(x, self.conv3))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return linear(x, self.fc, self.compute_dtype)


class LatentEncoder(nn.Module):
    """Dispatch on ``encoder_type``: ``custom`` -> :class:`ConvEncoder`."""

    def __init__(self, latent_dim: int = 256, encoder_type: str = "custom",
                 patch_size: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if encoder_type == "vgg":
            raise NotImplementedError(
                "the vgg encoder is not ported yet (ROADMAP queue 1, "
                "'VGG and perceptual ablations')"
            )
        if encoder_type != "custom":
            raise ValueError(f"Unknown encoder_type {encoder_type!r}")
        self.encoder = ConvEncoder(latent_dim, patch_size, compute_dtype, generator)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.encoder(patches)
