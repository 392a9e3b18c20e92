"""SIREN building blocks (counterpart of ``mri_inr_tpu/models/siren.py``).

- ``Sine`` / ``Morlet`` activations: ``sin(w0*x)`` and
  ``sin(w0*x) * exp(-x**2/2)``; the sine is the degree-9 polynomial
  ``fast_sin`` unless ``exact_sine``.
- SIREN init: weight and bias from ``U(-s, s)``, ``s = 1/dim_in`` for the
  first layer else ``sqrt(c/dim_in)/w0``, drawn from a ``torch.Generator``;
  the entry points draw the JAX package's own values instead
  (:func:`mri_inr_tpu_torch.models.flax_init.seeded`), from the
  initializer each layer names in its ``flax_init``.
- ``SirenNet``: hidden layers (first ``w0_initial``, rest ``w0``), dropout
  after every hidden activation (layer 0 included), FiLM modulation
  ``x *= mod[:, None, :]``, the residual variant, and an output layer that
  is always sine, with no modulation or dropout.
- ``Modulator``: ``Linear -> ReLU`` per layer, the latent re-concatenated
  before every layer after the first; Flax-default init (lecun-normal
  weights, zero bias).

Weights are stored as ``(out, in)`` like ``nn.Linear``; the Flax kernels are
``(in, out)`` (``interop.params_from_flax`` transposes). ``compute_dtype``
casts inputs and weights for the products (bf16 on the card); parameters
stay f32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mri_inr_tpu_torch.ops.fast_math import fast_sin


#: the Flax initializers of a Dense, Conv or ConvTranspose layer's
#: parameters, in the order Flax creates them (``flax_init.init_params``)
LECUN_ZEROS = {"weight": ("lecun_normal",), "bias": ("zeros",)}


def siren_uniform_init(tensor: torch.Tensor, scale: float,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """In place: ``U(-scale, scale)``."""
    with torch.no_grad():
        return tensor.uniform_(-scale, scale, generator=generator)


def lecun_normal_init(tensor: torch.Tensor, fan_in: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """In place: Flax's default kernel init, ``variance_scaling(1, fan_in,
    truncated_normal)`` (std corrected for the truncation at 2 sigma)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def dense(dim_in: int, dim_out: int,
          generator: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` with Flax ``nn.Dense``'s default init."""
    layer = nn.Linear(dim_in, dim_out)
    lecun_normal_init(layer.weight, dim_in, generator)
    nn.init.zeros_(layer.bias)
    layer.flax_init = LECUN_ZEROS
    return layer


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` with inputs, weight and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def apply_activation(pre: torch.Tensor, w0: float, activation: str,
                     exact: bool = False) -> torch.Tensor:
    sin = torch.sin if exact else fast_sin
    out = sin(w0 * pre)
    if activation == "morlet":
        out = out * torch.exp(-0.5 * torch.square(pre))
    return out


@functools.lru_cache(maxsize=None)
def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """The factor Flax's dropout puts on a kept element of ``dtype``:
    ``inputs / keep_prob`` with the weak-typed ``keep_prob = 1 - rate``
    rounded to ``dtype`` first (bf16: 0.9 -> 0.8984375), which XLA on the
    CPU computes as the product with the float32 reciprocal, rounded back to
    ``dtype``: the float32 value ``1 / keep_prob``."""
    keep = torch.tensor(1.0 - rate, dtype=dtype).item()
    return float(np.float32(1.0) / np.float32(keep))


def flax_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Flax's ``nn.Dropout`` of ``x`` with the bool ``keep`` mask:
    ``select(keep, x / keep_prob, 0)``, the kept values scaled as XLA
    rounds them (:func:`keep_scale`)."""
    return torch.where(keep, (x.float() * keep_scale(rate, x.dtype)).to(x.dtype), 0.0)


class SirenLayer(nn.Module):
    """One sine(-or-Morlet)-activated linear layer with SIREN init."""

    def __init__(self, dim_in: int, features: int, w0: float = 1.0,
                 c: float = 6.0, is_first: bool = False, use_bias: bool = True,
                 activation: str = "sine", dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 exact_sine: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w0 = w0
        self.activation = activation
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.exact_sine = exact_sine
        #: when set, train-mode dropout keeps the elements where
        #: ``dropout_mask_fn(shape)`` (a bool mask) is true instead of drawing
        #: from the global stream; the trainer sets Flax's masks here
        #: (``ops/dropout.py``)
        self.dropout_mask_fn = None
        scale = (1.0 / dim_in) if is_first else (c / dim_in) ** 0.5 / w0
        self.flax_init = {"weight": ("uniform", scale), "bias": ("uniform", scale)}
        self.weight = nn.Parameter(
            siren_uniform_init(torch.empty(features, dim_in), scale, generator))
        self.bias = (
            nn.Parameter(siren_uniform_init(torch.empty(features), scale, generator))
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = linear(x, self, self.compute_dtype)
        out = apply_activation(pre, self.w0, self.activation, self.exact_sine)
        if self.dropout > 0.0 and self.training and self.dropout_mask_fn is not None:
            out = flax_dropout(out, self.dropout_mask_fn(tuple(out.shape)), self.dropout)
        elif self.dropout > 0.0:
            out = F.dropout(out, self.dropout, training=self.training)
        return out


class SirenNet(nn.Module):
    """Modulated SIREN layers + an unmodulated sine output layer."""

    def __init__(self, dim_in: int = 2, dim_hidden: int = 256, dim_out: int = 1,
                 num_layers: int = 5, w0: float = 1.0, w0_initial: float = 30.0,
                 use_bias: bool = True, dropout: float = 0.1,
                 activation: str = "sine", residual: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 exact_sine: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.residual = residual
        common = dict(use_bias=use_bias, compute_dtype=compute_dtype,
                      exact_sine=exact_sine, generator=generator)
        self.layers = nn.ModuleList(
            SirenLayer(dim_in if i == 0 else dim_hidden, dim_hidden,
                       w0=w0_initial if i == 0 else w0, is_first=i == 0,
                       activation=activation, dropout=dropout, **common)
            for i in range(num_layers)
        )
        # ALWAYS sine, even for Morlet models (the reference's last Siren
        # takes the default activation)
        self.last_layer = SirenLayer(dim_hidden, dim_out, w0=w0,
                                     activation="sine", **common)

    def forward(self, coords: torch.Tensor,
                mods: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
        """coords (B, S, dim_in), mods: one (B, dim_hidden) per layer ->
        (B, S, dim_out)."""
        x = coords
        for i, layer in enumerate(self.layers):
            h = layer(x)
            if mods is not None:
                h = h * mods[i][:, None, :].to(h.dtype)
            x = x + h if (self.residual and i > 0) else h
        return self.last_layer(x)


class Modulator(nn.Module):
    """Latent -> per-layer FiLM modulations."""

    def __init__(self, latent_dim: int = 256, dim_hidden: int = 256,
                 num_layers: int = 5,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            dense(latent_dim if i == 0 else dim_hidden + latent_dim,
                  dim_hidden, generator)
            for i in range(num_layers)
        )

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, ...]:
        z = z.to(self.compute_dtype)
        x = z
        hiddens = []
        for layer in self.layers:
            x = torch.relu(linear(x, layer, self.compute_dtype))
            hiddens.append(x)
            x = torch.cat([x, z], dim=-1)
        return tuple(hiddens)
