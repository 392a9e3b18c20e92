"""Top-level modulated SIREN (counterpart of
``mri_inr_tpu/models/modulated_siren.py``).

encoder -> modulator -> SIREN over a fixed ``linspace(-1, 1, siren_patch)``
ij-meshgrid coordinate grid, output reshaped to (B, siren, siren).
``forward`` is the module-by-module path; the eval path runs the fused
forward of ``ops/siren_kernel.py`` over the same parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from mri_inr_tpu_torch.models.encoder import LatentEncoder
from mri_inr_tpu_torch.models.siren import Modulator, SirenNet
from mri_inr_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _coordinate_grid_np(size: int) -> np.ndarray:
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    ii, jj = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([ii, jj], axis=-1).reshape(size * size, 2)


@functools.lru_cache(maxsize=None)
def _coordinate_grid_on(size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_coordinate_grid_np(size).copy()).to(device)


def coordinate_grid(size: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """(size*size, 2) coordinates in [-1, 1]^2, row-major (i, j) order. One
    read-only tensor per (size, device), made once: a fresh upload on every
    forward would make the host wait for the device's stream each time."""
    return _coordinate_grid_on(size, torch.device(device))


class ModulatedSiren(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (the default
    generator when None) and then moved to ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``)."""

    def __init__(self, dim_in: int = 2, dim_hidden: int = 256, dim_out: int = 1,
                 num_layers: int = 5, latent_dim: int = 256, w0: float = 1.0,
                 w0_initial: float = 30.0, use_bias: bool = True,
                 dropout: float = 0.1, encoder_type: str = "custom",
                 outer_patch_size: int = 32, inner_patch_size: int = 16,
                 siren_patch_size: int = 24, activation: str = "sine",
                 residual: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 exact_sine: bool = False, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.dropout = dropout
        self.w0 = w0
        self.w0_initial = w0_initial
        self.activation = activation
        self.residual = residual
        self.outer_patch_size = outer_patch_size
        self.inner_patch_size = inner_patch_size
        self.siren_patch_size = siren_patch_size
        self.compute_dtype = compute_dtype
        self.net = SirenNet(dim_in, dim_hidden, dim_out, num_layers, w0,
                            w0_initial, use_bias, dropout, activation, residual,
                            compute_dtype, exact_sine, generator)
        self.modulator = Modulator(latent_dim, dim_hidden, num_layers,
                                   compute_dtype, generator)
        self.encoder = LatentEncoder(latent_dim, encoder_type, outer_patch_size,
                                     compute_dtype, generator)
        self.to(device)

    def forward(self, tiles: torch.Tensor) -> torch.Tensor:
        """(B, outer, outer) undersampled patches -> (B, siren, siren)."""
        batch = tiles.shape[0]
        mods = self.modulations(tiles)
        s = self.siren_patch_size
        coords = coordinate_grid(s, tiles.device).to(self.compute_dtype)
        out = self.net(coords.expand(batch, s * s, 2), mods)
        return out[..., 0].reshape(batch, s, s)

    def encode(self, tiles: torch.Tensor) -> torch.Tensor:
        return self.encoder(tiles)

    def modulations(self, tiles: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.modulator(self.encoder(tiles))


def from_config(model_cfg, precision: str = "fp32", *,
                generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> ModulatedSiren:
    """Build from a :class:`~mri_inr_tpu_torch.configuration.ModelConfig`."""
    return ModulatedSiren(
        dim_in=model_cfg.dim_in,
        dim_hidden=model_cfg.dim_hidden,
        dim_out=model_cfg.dim_out,
        num_layers=model_cfg.num_layers,
        latent_dim=model_cfg.latent_dim,
        w0=model_cfg.w0,
        w0_initial=model_cfg.w0_initial,
        use_bias=model_cfg.use_bias,
        dropout=model_cfg.dropout,
        encoder_type=model_cfg.encoder_type,
        outer_patch_size=model_cfg.outer_patch_size,
        inner_patch_size=model_cfg.inner_patch_size,
        siren_patch_size=model_cfg.siren_patch_size,
        activation=model_cfg.activation,
        residual=model_cfg.residual,
        compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
        generator=generator,
        device=device,
    )
