"""Carry weights and Adam state between a Flax ``ModulatedSiren`` param tree
and the port.

Takes numpy arrays only (no JAX import): the caller turns a JAX tree into
numpy with ``jax.device_get``. The mapping:

- path ``net/layer_3/kernel`` -> key ``net.layers.3.weight`` (every
  ``layer_<i>`` becomes ``layers.<i>``, ``kernel`` becomes ``weight``);
- Dense / SIREN kernels ``(in, out)`` -> ``(out, in)``;
- Conv kernels HWIO ``(kh, kw, cin, cout)`` -> OIHW ``(cout, cin, kh, kw)``;
- ConvTranspose kernels (the modules the JAX package names ``deconv``,
  ``deconv<i>`` and ``up_<i>``) ``(kh, kw, cin, cout)`` -> ``(cin, cout, kh,
  kw)`` flipped in both spatial axes (``models.encoder.ConvTranspose``);
- BatchNorm ``scale`` -> ``weight`` (``bias`` stays), and its
  ``batch_stats`` ``mean`` / ``var`` -> the buffers ``running_mean`` /
  ``running_var`` (``models.perceptual.BatchNorm``, which keeps no
  ``num_batches_tracked``, so the load is strict).

:func:`params_to_flax` is the inverse. A Flax ``variables`` dict with
``params`` and ``batch_stats`` goes through :func:`variables_from_flax` /
:func:`variables_to_flax`, which merge the two trees into one state dict
and split it again. An ``optax.adam`` state (``count``,
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


#: Flax module names of the ConvTranspose layers in the JAX package's trees
CONV_TRANSPOSE = re.compile(r"^(deconv\d*|up_\d+)$")
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                  "var": "running_var"}
_STATS = ("mean", "var")


def _torch_name(part: str) -> str:
    if part in _LEAF_TO_TORCH:
        return _LEAF_TO_TORCH[part]
    return re.sub(r"^layer_(\d+)$", r"layers.\1", part)


def _is_transposed(path) -> bool:
    return len(path) >= 2 and CONV_TRANSPOSE.match(path[-2]) is not None


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
            elif name == "kernel" and arr.ndim == 4 and _is_transposed(path):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(_torch_name(p) for p in path)
            out[key] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, ())
    return out


def _merge(a: Mapping, b: Mapping) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, Mapping) else v
    return out


def variables_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``{"params": ..., "batch_stats": ...}`` (numpy trees) -> one
    ``state_dict`` with the running statistics as buffers."""
    return params_from_flax(_merge(variables["params"], variables.get("batch_stats", {})))


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a Flax param tree into ``model`` (strict: every key must match)."""
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def flax_leaf(key: str, arr: np.ndarray) -> tuple[list[str], np.ndarray]:
    """One ``state_dict`` entry -> (its path in the Flax tree, the array in
    Flax layout, a view where only axes move)."""
    path = re.sub(r"layers\.(\d+)", r"layer_\1", key).split(".")
    if path[-1] == "weight" and arr.ndim == 1:  # a BatchNorm's
        path[-1] = "scale"
    elif path[-1] == "weight":
        path[-1] = "kernel"
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4 and _is_transposed(path):
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
    elif path[-1] in ("running_mean", "running_var"):
        path[-1] = path[-1][len("running_"):]
    return path, arr


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """``state_dict`` -> nested dict of f32 numpy arrays in Flax layout (the
    inverse of :func:`params_from_flax`). Every array is a copy: none shares
    memory with a tensor of ``state_dict``, so a later in-place update of
    the module (an optimizer step) leaves the tree as it was."""
    out: dict = {}
    for key, value in state_dict.items():
        path, arr = flax_leaf(key, value.detach().cpu().float().numpy())
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(arr, dtype=np.float32, order="C", copy=True)
    return out


def variables_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`variables_from_flax`: ``{"params": ...,
    "batch_stats": ...}``, the second only where the state dict holds
    running statistics."""
    def split(tree: Mapping, stats: bool) -> dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                sub = split(v, stats)
                if sub:
                    out[k] = sub
            elif (k in _STATS) == stats:
                out[k] = v
        return out

    tree = params_to_flax(state_dict)
    out = {"params": split(tree, False)}
    stats = split(tree, True)
    if stats:
        out["batch_stats"] = stats
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
