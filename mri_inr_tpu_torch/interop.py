"""Carry weights from a Flax ``ModulatedSiren`` param tree into the port.

Takes numpy arrays only (no JAX import): the caller turns a JAX tree into
numpy with ``jax.device_get``. The mapping:

- path ``net/layer_3/kernel`` -> key ``net.layers.3.weight`` (every
  ``layer_<i>`` becomes ``layers.<i>``, ``kernel`` becomes ``weight``);
- Dense / SIREN kernels ``(in, out)`` -> ``(out, in)``;
- Conv kernels HWIO ``(kh, kw, cin, cout)`` -> OIHW ``(cout, cin, kh, kw)``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn


def _torch_name(part: str) -> str:
    if part == "kernel":
        return "weight"
    return re.sub(r"^layer_(\d+)$", r"layers.\1", part)


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``state_dict`` of f32 tensors."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple[str, ...]):
        for name, value in tree.items():
            path = prefix + (name,)
            if isinstance(value, Mapping):
                walk(value, path)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel" and arr.ndim == 2:
                arr = arr.T
            elif name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(_torch_name(p) for p in path)
            out[key] = torch.tensor(arr)

    walk(params, ())
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a Flax param tree into ``model`` (strict: every key must match)."""
    model.load_state_dict(params_from_flax(params), strict=True)
    return model
