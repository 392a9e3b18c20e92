"""Patch encoders and their autoencoders (counterpart of
``mri_inr_tpu/models/encoder.py``).

``ConvEncoder`` is the ``custom`` latent encoder: Conv(1->16, k3, s2, p1) ->
LeakyReLU(0.2) -> Conv(16->32, k3, s2, p1) -> LeakyReLU -> Conv(32->64, k8,
valid) -> LeakyReLU -> flatten -> Linear(-> latent). Flax's
``Conv(k3, s2, padding=((1, 1), (1, 1)))`` is ``Conv2d(stride=2,
padding=1)``. ``ConvAutoencoder`` adds the mirror ``ConvDecoder`` for
pretraining (``cli/train_encoder.py``). The ``vgg`` encoder is the VGG16
conv stack with a 1-channel first conv (``VGGTrunk``), torch's adaptive
average pool to 7x7 and a latent projection; ``VGGAutoencoder`` pretrains
the trunk.

The JAX package computes in NHWC; here the convolutions run in NCHW and a
feature map is put back in NHWC order before every flatten, so the ``fc``
weights map one to one for any patch size.

Flax's ``ConvTranspose`` does not flip its kernel and pads ``"SAME"`` /
``"VALID"`` by ``lax.conv_transpose``'s rule. :class:`ConvTranspose`
stores the kernel as ``conv_transpose2d`` wants it, ``(in, out, kh, kw)``
and flipped in both spatial axes (``interop`` does the flip), runs
``conv_transpose2d(padding=0)`` and keeps the window Flax's padding keeps:
for a 3x3 kernel at stride 2 ``"SAME"`` the first ``2 * H_in`` rows and
columns, an asymmetric crop no ``padding`` / ``output_padding`` of
``ConvTranspose2d`` gives.

Conv and Dense layers take Flax's default init (lecun-normal, zero bias),
not torch's. ``compute_dtype`` casts inputs, weights and biases for every
product (bf16 on the card); parameters stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mri_inr_tpu_torch.models.siren import LECUN_ZEROS, dense, lecun_normal_init, linear


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          generator: torch.Generator | None, bias: bool = True) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
    lecun_normal_init(conv.weight, cin * kernel * kernel, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    conv.flax_init = LECUN_ZEROS
    return conv


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on ``x`` with input, weight and bias cast to ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, stride=conv.stride,
                    padding=conv.padding)


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W*C) in Flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _transpose_padding(kernel: int, stride: int, padding: str) -> tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input (own
    copy of its rule)."""
    if padding == "SAME":
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = kernel + stride - 2 + max(kernel - stride, 0)
        pad_a = kernel - 1
    else:
        raise ValueError(f"padding {padding!r}")
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose(features, (k, k), strides=(s, s), padding)``
    (``transpose_kernel=False``) on NCHW input. ``weight`` is ``(in, out, k,
    k)``, the Flax kernel flipped spatially."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        pad_a, pad_b = _transpose_padding(kernel, stride, padding)
        # conv_transpose2d(padding=0) pads the dilated input by k - 1 on each side
        self.crop = (kernel - 1 - pad_a, kernel - 1 - pad_b)
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_init(self.weight, cin * kernel * kernel, generator)
        self.flax_init = LECUN_ZEROS

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype),
                               stride=self.stride)
        a, b = self.crop
        if a or b:
            h, w = y.shape[-2:]
            y = y[..., a : h - b, a : w - b]
        return y


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

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = patches.to(dt)[:, None]  # NCHW
        x = leaky_relu(conv2d(x, self.conv1, dt))
        x = leaky_relu(conv2d(x, self.conv2, dt))
        x = leaky_relu(conv2d(x, self.conv3, dt))
        return linear(nhwc_flatten(x), self.fc, dt)


class ConvDecoder(nn.Module):
    """Mirror decoder: (B, latent_dim) -> (B, 32, 32) in [0, 1]."""

    def __init__(self, latent_dim: int = 256, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = dense(latent_dim, 64, generator)
        self.deconv1 = ConvTranspose(64, 32, 8, 1, "VALID", generator)
        self.deconv2 = ConvTranspose(32, 16, 3, 2, "SAME", generator)
        self.deconv3 = ConvTranspose(16, 1, 3, 2, "SAME", generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = leaky_relu(linear(z.to(dt), self.fc, dt))
        x = x.reshape(x.shape[0], 64, 1, 1)
        x = leaky_relu(self.deconv1(x, dt))
        x = leaky_relu(self.deconv2(x, dt))
        x = self.deconv3(x, dt)
        return torch.sigmoid(x)[:, 0]


class ConvAutoencoder(nn.Module):
    """Pretraining autoencoder (identity reconstruction of fully sampled
    tiles); ``encode`` is the encoder the SIREN's ``custom`` encoder takes
    over (``model.encoder_path``)."""

    def __init__(self, latent_dim: int = 256, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = ConvEncoder(latent_dim, 32, compute_dtype, generator)
        self.decoder = ConvDecoder(latent_dim, compute_dtype, generator)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(patches))

    def encode(self, patches: torch.Tensor) -> torch.Tensor:
        return self.encoder(patches)


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: tuple[int, int]) -> torch.Tensor:
    """torch's ``AdaptiveAvgPool2d`` bins on NCHW input: output bin (i, j)
    averages input rows ``floor(i*H/oh) : ceil((i+1)*H/oh)`` (and likewise
    for columns), down or up. A 1x1 map (the VGG trunk's on 32x32 patches)
    becomes copies by ``expand``, whose backward is one sum: the card's
    ``adaptive_avg_pool2d`` backward adds the 49 bins' gradients into one
    element by bf16 atomics, 45 ms of a 55 ms VGG train step at batch 400
    on an H100."""
    if x.shape[-2:] == (1, 1):
        return x.expand(*x.shape[:-2], *output_size)
    return F.adaptive_avg_pool2d(x, output_size)


VGG16_CONFIG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M")


class VGGTrunk(nn.Module):
    """The VGG16 conv stack with 1-channel input: (B, P, P) -> the NCHW
    feature map after five stages of 3x3 convs + ReLU and 2x2 max pools
    (512 x 1 x 1 for 32x32 patches). ``conv_0`` has no bias. Shared by
    :class:`VGGEncoder` and :class:`VGGAutoencoder`, so pretrained weights
    move by the ``trunk.`` subtree."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.plan = []
        cin = 1
        for item in VGG16_CONFIG:
            if item == "M":
                self.plan.append(None)
                continue
            idx = len(self.plan) - self.plan.count(None)
            self.add_module(f"conv_{idx}", _conv(cin, item, 3, 1, 1, generator, bias=idx > 0))
            self.plan.append(f"conv_{idx}")
            cin = item

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = patches.to(dt)[:, None]
        for name in self.plan:
            x = F.max_pool2d(x, 2, 2) if name is None else torch.relu(
                conv2d(x, getattr(self, name), dt))
        return x


class VGGEncoder(nn.Module):
    """VGG16 trunk -> adaptive 7x7 average pool -> NHWC flatten (7*7*512)
    -> Linear(-> latent): the ``vgg`` encoder_type."""

    def __init__(self, latent_dim: int = 256, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trunk = VGGTrunk(compute_dtype, generator)
        self.fc = dense(7 * 7 * 512, latent_dim, generator)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool_2d(self.trunk(patches), (7, 7))
        return linear(nhwc_flatten(x), self.fc, self.compute_dtype)


VGG_DECODER_STAGES = ((512, 512, 512), (512, 512, 512), (256, 256, 256), (128, 128),
                      (64, 64))


class VGGDecoder(nn.Module):
    """Mirror decoder: trunk features -> (B, P, P) in [0, 1]. Five stages,
    each a 2x2 stride-2 ConvTranspose (``up_<i>``) and 3x3 convs
    (``conv_<i>``) with ReLU, reversing the VGG16 stage channels, then a 3x3
    conv to one channel and a sigmoid. The names follow the JAX package's
    counter."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.plan = []  # (kind, name) in order
        idx, cin = 0, 512
        for chs in VGG_DECODER_STAGES:
            self.add_module(f"up_{idx}", ConvTranspose(cin, chs[0], 2, 2, "SAME", generator))
            self.plan.append(("up", f"up_{idx}"))
            cin = chs[0]
            for c in chs[1:]:
                self.add_module(f"conv_{idx}", _conv(cin, c, 3, 1, 1, generator))
                self.plan.append(("conv", f"conv_{idx}"))
                cin = c
                idx += 1
            idx += 1
        self.out = _conv(cin, 1, 3, 1, 1, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = feats.to(dt)
        for kind, name in self.plan:
            layer = getattr(self, name)
            x = torch.relu(layer(x, dt) if kind == "up" else conv2d(x, layer, dt))
        return torch.sigmoid(conv2d(x, self.out, dt))[:, 0]


class VGGAutoencoder(nn.Module):
    """VGG16 autoencoder for the in-framework pretraining of the ``vgg``
    encoder_type (no ImageNet weights): ``train_encoder --model vgg``
    trains it, and the train CLI splices its ``trunk.`` into the SIREN's
    encoder, leaving the ``fc`` head fresh."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = VGGTrunk(compute_dtype, generator)
        self.decoder = VGGDecoder(compute_dtype, generator)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.trunk(patches))


class LatentEncoder(nn.Module):
    """Dispatch on ``encoder_type``: ``custom`` -> :class:`ConvEncoder`,
    ``vgg`` -> :class:`VGGEncoder`."""

    def __init__(self, latent_dim: int = 256, encoder_type: str = "custom",
                 patch_size: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if encoder_type == "custom":
            self.encoder = ConvEncoder(latent_dim, patch_size, compute_dtype, generator)
        elif encoder_type == "vgg":
            self.encoder = VGGEncoder(latent_dim, compute_dtype, generator)
        else:
            raise ValueError(f"Unknown encoder_type {encoder_type!r}")

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.encoder(patches)
