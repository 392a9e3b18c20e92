"""The JAX package's seeded initialisation, drawn without JAX: for a port
model, the parameters that its Flax counterpart's
``model.init(jax.random.key(seed), sample)["params"]`` returns.

Flax gives every parameter its own key: the root key with the SHA-1 of the
parameter's scope path and a per-scope counter folded in
(``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``, ``make_rng``).
A scope counts the keys it hands out, from 1, in the order its parameters
are created: a Dense, Conv or ConvTranspose layer's kernel is 1 and its
bias 2, a BatchNorm's scale 1 and its bias 2, a SIREN layer's kernel 1 and
its bias 2. The key then goes to the parameter's initializer:

- ``uniform``: ``jax.random.uniform(key, shape, -s, s)`` (the SIREN layers);
- ``lecun_normal``: ``truncated_normal(key, -2, 2, shape) * sqrt(1 /
  fan_in) / 0.8796...`` in float32, ``fan_in`` the product of every axis
  of the Flax kernel but the last (HWIO for a Conv, and for a ConvTranspose,
  whose Flax kernel is ``(kh, kw, in, out)``, the same);
- ``zeros``, ``ones``.

The parameter names, shapes and layout come from the port's module through
:func:`mri_inr_tpu_torch.interop.flax_leaf`, which maps a ``state_dict`` key
to its Flax path; each leaf's initializer from the ``flax_init`` of the
port's layer that owns it (in Flax's creation order). The draws are those of
:mod:`mri_inr_tpu_torch.utils.jax_random`: the uniform, zero and one leaves
equal Flax's bit for bit, the truncated-normal leaves lie within an ulp or
two of them. None of it depends on the installed torch.

:func:`dropout_keys` gives, the same way, the keys a train-mode ``apply``
hands each ``nn.Dropout`` of the model (the module path's masks,
``ops/dropout.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np
from torch import nn

from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.utils import jax_random

#: lecun_normal's correction of the standard deviation for the truncation
#: at two sigma (``jax.nn.initializers.variance_scaling``)
_TRUNCATED_STD = 0.87962566103423978


def static_data(*suffix: str | int) -> int:
    """The integer Flax's ``_fold_in_static`` folds in for ``suffix``: the
    first four bytes (big-endian) of the SHA-1 of its parts (strings as
    UTF-8, ints as their shortest big-endian bytes, no separator)."""
    m = hashlib.sha1()
    for part in suffix:
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_static(key: np.ndarray, *suffix: str | int) -> np.ndarray:
    """Flax's ``_fold_in_static``: fold :func:`static_data` of the suffix
    into ``key`` (keys ``(..., 2)`` each)."""
    if not suffix:
        return key
    return jax_random.fold_in(key, static_data(*suffix))


def dropout_layers(model: nn.Module) -> list[tuple[nn.Module, tuple[str, ...]]]:
    """The layers of ``model`` that drop (a ``dropout`` rate and a
    ``dropout_mask_fn`` slot: the SIREN's hidden layers), in module order,
    each with its Flax scope path, taken from its weight's leaf
    (:func:`mri_inr_tpu_torch.interop.flax_leaf`): ``("net", "layer_i")``
    in a ``ModulatedSiren``."""
    out = []
    for name, module in model.named_modules():
        if hasattr(module, "dropout_mask_fn") and module.dropout > 0.0:
            path, _ = interop.flax_leaf(f"{name}.weight", np.zeros((1, 1), np.float32))
            out.append((module, tuple(path[:-1])))
    return out


def dropout_keys(model: nn.Module, step_keys: np.ndarray) -> np.ndarray:
    """The ``(..., L, 2)`` dropout keys of the L dropping layers
    (:func:`dropout_layers`) for step keys ``(..., 2)`` (the ``rngs=
    {"dropout": k}`` of an ``apply``): each layer's ``nn.Dropout`` is its
    scope's ``Dropout_0``, whose first ``make_rng("dropout")`` is
    ``fold_in_static(k, *path, "Dropout_0", 1)`` (``flax/core/scope.py``:
    ``LazyRng``, ``make_rng``)."""
    data = [static_data(*path, "Dropout_0", 1) for _, path in dropout_layers(model)]
    step_keys = np.asarray(step_keys, np.uint32)
    return jax_random.fold_in(step_keys[..., None, :], np.array(data, np.int64))


def _draw(spec: tuple, key: np.ndarray, shape: tuple) -> np.ndarray:
    kind = spec[0]
    if kind == "uniform":
        return jax_random.uniform(key, shape, -spec[1], spec[1])
    if kind == "lecun_normal":
        fan_in = float(np.prod(shape[:-1]))
        variance = np.float32(1.0 / fan_in)
        std = np.sqrt(variance) / np.float32(_TRUNCATED_STD)
        return jax_random.truncated_normal(key, -2.0, 2.0, shape) * std
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    raise ValueError(f"unknown initializer {spec!r}")


def init_params(model: nn.Module, seed: int) -> dict:
    """The Flax ``params`` tree of ``model`` at ``jax.random.key(seed)``:
    nested dicts of float32 numpy arrays in Flax's names and layout."""
    root = jax_random.key(seed)
    todo = dict(model.named_parameters())
    out: dict = {}
    for name, module in model.named_modules():
        spec = getattr(module, "flax_init", {})
        prefix = f"{name}." if name else ""
        own = [leaf for leaf in spec if f"{prefix}{leaf}" in todo]
        for counter, leaf in enumerate(own, start=1):
            key = f"{prefix}{leaf}"
            path, arr = interop.flax_leaf(key, todo.pop(key).detach().cpu().numpy())
            value = _draw(spec[leaf], fold_in_static(root, *path[:-1], counter), arr.shape)
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = value.astype(np.float32)
    if todo:
        raise ValueError(f"no Flax initializer named for {sorted(todo)}")
    return out


def seeded(model: nn.Module, seed: int) -> nn.Module:
    """Load :func:`init_params` of ``seed`` into ``model`` (in place, on its
    device; BatchNorm running statistics keep their values) and return
    it."""
    stats = interop.variables_to_flax(model.state_dict()).get("batch_stats", {})
    state = interop.variables_from_flax({"params": init_params(model, seed),
                                         "batch_stats": stats})
    model.load_state_dict(state, strict=True)
    return model
