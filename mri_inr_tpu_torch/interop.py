"""Carry weights and Adam state between a Flax ``ModulatedSiren`` param tree
and the port.

Takes numpy arrays only (no JAX import): the caller turns a JAX tree into
numpy with ``jax.device_get``. The mapping:

- path ``net/layer_3/kernel`` -> key ``net.layers.3.weight`` (every
  ``layer_<i>`` becomes ``layers.<i>``, ``kernel`` becomes ``weight``);
- Dense / SIREN kernels ``(in, out)`` -> ``(out, in)``;
- Conv kernels HWIO ``(kh, kw, cin, cout)`` -> OIHW ``(cout, cin, kh, kw)``.

:func:`params_to_flax` is the inverse. An ``optax.adam`` state (``count``,
``mu``, ``nu``; the moment trees have the params' layout) maps onto
``torch.optim.Adam``'s ``state_dict`` by the same rules
(:func:`adam_state_from_optax`, :func:`adam_state_to_optax`), so a resume
test can start both sides from one state.

Nothing else needs carrying. The int8 chain's parameters
(``ops.siren_kernel.Int8SirenParams``) are derived from the transplanted
model by the port's own ``quantize_kernel_params``, which the tests hold to
the JAX derivation (the int8 weights equal as integers, the scales within
1e-7 relative). The FFT plans and twiddle tables of ``ops.fft_kernel`` are
derived from the size ``n`` alone.
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


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """``state_dict`` -> nested dict of f32 numpy arrays in Flax layout (the
    inverse of :func:`params_from_flax`)."""
    out: dict = {}
    for key, value in state_dict.items():
        path = re.sub(r"layers\.(\d+)", r"layer_\1", key).split(".")
        arr = value.detach().cpu().float().numpy()
        if path[-1] == "weight":
            path[-1] = "kernel"
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def adam_state_from_optax(model: nn.Module, optimizer: torch.optim.Adam, count: int,
                          mu: Mapping, nu: Mapping) -> dict:
    """An ``optax.adam`` state as numpy trees -> a ``state_dict`` that
    ``optimizer.load_state_dict`` takes. ``optimizer`` must hold
    ``model.parameters()`` in order, in one group."""
    m, v = params_from_flax(mu), params_from_flax(nu)
    state = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m[name], "exp_avg_sq": v[name]}
        for i, (name, _) in enumerate(model.named_parameters())
    }
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def adam_state_to_optax(model: nn.Module, optimizer: torch.optim.Adam) -> tuple[int, dict, dict]:
    """``(count, mu, nu)`` of ``optimizer`` with the moments in Flax layout
    (the inverse of :func:`adam_state_from_optax`)."""
    state = optimizer.state_dict()["state"]
    names = [name for name, _ in model.named_parameters()]
    count = int(state[0]["step"]) if state else 0
    mu = params_to_flax({n: state[i]["exp_avg"] for i, n in enumerate(names)})
    nu = params_to_flax({n: state[i]["exp_avg_sq"] for i, n in enumerate(names)})
    return count, mu, nu
