"""Perceptual-loss autoencoders (counterpart of
``mri_inr_tpu/models/perceptual.py``): VGG-like conv blocks with BatchNorm.

EncoderBlock = 2 x (Conv3x3 -> BatchNorm -> LeakyReLU(0.2)) -> MaxPool 2;
DecoderBlock mirrors it with a 2x2 stride-2 ConvTranspose at the end;
FullyConnectedBlock = Linear -> BatchNorm -> LeakyReLU(0.2). ``V2`` is the
2-stage variant on 24x24 inputs with a 256-d latent, the encoder of the
perceptual loss (``train/losses.py``); ``V1`` the 3-stage 512 -> 256 one.

Layout: NCHW convolutions; the encoder's flatten and the decoder's
``(B, m, m, C)`` reshape are in Flax's NHWC order, so the Dense weights map
one to one.

:class:`BatchNorm` updates as Flax's ``nn.BatchNorm`` does, which
``nn.BatchNorm2d`` does not: batch statistics in f32 with the variance as
``E[x^2] - E[x]^2`` (the biased one, clipped at 0), running averages
``0.99 * running + 0.01 * batch`` with that biased variance, ``eps`` 1e-5,
and no ``num_batches_tracked``: its state dict maps one to one onto Flax's
``params`` (``scale``, ``bias``) and ``batch_stats`` (``mean``, ``var``),
so a strict load works both ways (``interop``). ``module.train()`` is
Flax's ``train=True``: batch statistics, running averages updated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mri_inr_tpu_torch.models.encoder import ConvTranspose, _conv, conv2d, nhwc_flatten
from mri_inr_tpu_torch.models.siren import dense, linear

MOMENTUM = 0.99  # Flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch
EPSILON = 1e-5


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over every axis but the channel axis 1 (NCHW or
    (B, C))."""

    flax_init = {"weight": ("ones",), "bias": ("zeros",)}

    def __init__(self, features: int, momentum: float = MOMENTUM, eps: float = EPSILON):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # statistics in f32 at least
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv_0 = _conv(cin, features, 3, 1, 1, generator)
        self.bn_0 = BatchNorm(features)
        self.conv_1 = _conv(features, features, 3, 1, 1, generator)
        self.bn_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        for conv, bn in ((self.conv_0, self.bn_0), (self.conv_1, self.bn_1)):
            x = F.leaky_relu(bn(conv2d(x, conv, dt)), 0.2)
        return F.max_pool2d(x, 2, 2)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv_0 = _conv(cin, features, 3, 1, 1, generator)
        self.bn_0 = BatchNorm(features)
        self.conv_1 = _conv(features, features, 3, 1, 1, generator)
        self.bn_1 = BatchNorm(features)
        self.deconv = ConvTranspose(features, features, 2, 2, "SAME", generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        for conv, bn in ((self.conv_0, self.bn_0), (self.conv_1, self.bn_1)):
            x = F.leaky_relu(bn(conv2d(x, conv, dt)), 0.2)
        return self.deconv(x, dt)


class FullyConnectedBlock(nn.Module):
    def __init__(self, cin: int, features: int, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = dense(cin, features, generator)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(linear(x, self.fc, self.compute_dtype)), 0.2)


class PerceptualEncoderV2(nn.Module):
    """(B, 24, 24) -> (B, 256): two conv stages + FC."""

    def __init__(self, img_size: int = 24, latent_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block_0 = EncoderBlock(1, 64, compute_dtype, generator)
        self.block_1 = EncoderBlock(64, 128, compute_dtype, generator)
        m = img_size // 4
        self.fc_block = FullyConnectedBlock(128 * m * m, latent_dim, compute_dtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.compute_dtype)[:, None]
        x = self.block_1(self.block_0(x))
        return self.fc_block(nhwc_flatten(x))


class PerceptualAutoencoderV2(nn.Module):
    """24x24 reconstruction autoencoder whose encoder is the perceptual
    loss's feature extractor."""

    def __init__(self, img_size: int = 24, latent_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.m = img_size // 4
        self.encoder = PerceptualEncoderV2(img_size, latent_dim, compute_dtype, generator)
        self.dec_fc = FullyConnectedBlock(latent_dim, 128 * self.m * self.m, compute_dtype,
                                          generator)
        self.dec_block_0 = DecoderBlock(128, 64, compute_dtype, generator)
        self.dec_block_1 = DecoderBlock(64, 1, compute_dtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.dec_fc(self.encoder(images))
        x = x.reshape(x.shape[0], self.m, self.m, 128).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.dec_block_1(self.dec_block_0(x))
        return torch.sigmoid(x)[:, 0]


class PerceptualEncoderV1(nn.Module):
    """(B, 24, 24) -> (B, 256): three conv stages down to 3x3, then FC 512
    -> 256."""

    def __init__(self, img_size: int = 24, latent_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block_0 = EncoderBlock(1, 64, compute_dtype, generator)
        self.block_1 = EncoderBlock(64, 128, compute_dtype, generator)
        self.block_2 = EncoderBlock(128, 256, compute_dtype, generator)
        m = img_size // 8
        self.fc_block_0 = FullyConnectedBlock(256 * m * m, 512, compute_dtype, generator)
        self.fc_block_1 = FullyConnectedBlock(512, latent_dim, compute_dtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.compute_dtype)[:, None]
        x = self.block_2(self.block_1(self.block_0(x)))
        return self.fc_block_1(self.fc_block_0(nhwc_flatten(x)))


class PerceptualAutoencoderV1(nn.Module):
    """3-stage 24x24 reconstruction autoencoder."""

    def __init__(self, img_size: int = 24, latent_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.m = img_size // 8
        self.encoder = PerceptualEncoderV1(img_size, latent_dim, compute_dtype, generator)
        self.dec_fc_0 = FullyConnectedBlock(latent_dim, 512, compute_dtype, generator)
        self.dec_fc_1 = FullyConnectedBlock(512, 256 * self.m * self.m, compute_dtype,
                                            generator)
        self.dec_block_0 = DecoderBlock(256, 128, compute_dtype, generator)
        self.dec_block_1 = DecoderBlock(128, 64, compute_dtype, generator)
        self.dec_block_2 = DecoderBlock(64, 1, compute_dtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.dec_fc_1(self.dec_fc_0(self.encoder(images)))
        x = x.reshape(x.shape[0], self.m, self.m, 256).permute(0, 3, 1, 2)
        x = self.dec_block_2(self.dec_block_1(self.dec_block_0(x)))
        return torch.sigmoid(x)[:, 0]
