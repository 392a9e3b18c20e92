"""The module path's dropout masks as Flax draws them: ``jax.random.
bernoulli(key, keep, shape)`` per element, from a threefry2x32 key.

Flax's ``nn.Dropout`` (``flax/linen/stochastic.py``) keeps an element where
``bernoulli(key, keep_prob, shape)`` is true. ``jax.random.bernoulli`` is
``uniform(key, shape, float32) < keep`` (``jax/_src/random.py``:
``bernoulli``, ``_bernoulli``), and ``uniform`` takes the 32 bits
``random_bits`` draws per element (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_random_bits_partitionable``, under
``jax_threefry_partitionable``, JAX's default):

- element ``n`` of the flat shape (``n + offset`` here) is hashed as the
  counter pair ``(n >> 32, n & 0xffffffff)`` under the key, 20 rounds and
  five key injections of Threefry-2x32, and its bits are ``x0 ^ x1``;
- the float is ``((bits >> 9) | 0x3f800000)`` read as float32, less 1
  (``_uniform``: the top 23 bits under the exponent of 1.0; ``minval`` 0
  and ``maxval`` 1 leave it as it is);
- the element is kept where that float is ``<`` ``float32(keep)``.

``offset`` lets a rank draw its rows of a global mask: rank ``r`` of ``N``
over a batch of ``B`` rows of ``(S, H)`` elements draws its ``(B/N, S, H)``
at ``offset = r * (B/N) * S * H``, as the JAX module path's one global mask
(GSPMD) splits over the devices.

- :func:`threefry_bits_reference` and :func:`threefry_keep_mask_reference`
  are the plain versions, in int64 tensor operations masked to 32 bits: the
  same values as :func:`mri_inr_tpu_torch.utils.jax_random.random_bits`, on
  the CPU and on the card.
- :func:`threefry_keep_mask_cuda` launches ``csrc/threefry_dropout.cu``,
  which reads its key from a device buffer (so a CUDA graph's replay after
  the key is restaged draws the new mask) and writes one byte an element;
  it counts one launch per call.
- :func:`threefry_keep_mask` takes the kernel for a key on the card and the
  plain version for a key on the CPU.

The kernel is no counterpart of a Pallas kernel: the JAX package draws
these bits through XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from mri_inr_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _check_keys(keys: torch.Tensor) -> None:
    if keys.shape != (2,) or keys.dtype != torch.int32:
        raise ValueError(f"expected a (2,) int32 key (uint32 bits), got "
                         f"{tuple(keys.shape)} {keys.dtype}")


def threefry_bits_reference(keys: torch.Tensor, numel: int, offset: int = 0) -> torch.Tensor:
    """(numel,) int64 holding the uint32 ``x0 ^ x1`` of Threefry-2x32 under
    ``keys`` (a (2,) int32 tensor of the key's uint32 bits) of the counters
    ``offset .. offset + numel - 1``, each split as ``(hi, lo)``."""
    _check_keys(keys)
    k = keys.to(torch.int64) & _M32
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    idx = torch.arange(offset, offset + numel, dtype=torch.int64, device=keys.device)
    x0 = ((idx >> 32) + ks[0]) & _M32
    x1 = ((idx & _M32) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0 ^ x1


def threefry_keep_mask_reference(keys: torch.Tensor, shape, keep: float,
                                 offset: int = 0) -> torch.Tensor:
    """Plain version: the bool keep mask of ``shape``, ``uniform < keep``
    in float32 as ``jax.random.bernoulli`` computes it."""
    shape = tuple(int(d) for d in shape)
    bits = threefry_bits_reference(keys, math.prod(shape), offset)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (floats < float(np.float32(keep))).reshape(shape)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("threefry_dropout")
    p = ctypes.c_void_p
    lib.threefry_keep_mask_launch.argtypes = [p, p, ctypes.c_longlong, ctypes.c_ulonglong,
                                              ctypes.c_float, p]
    lib.threefry_keep_mask_launch.restype = ctypes.c_int
    lib.threefry_dropout_error_string.argtypes = [ctypes.c_int]
    lib.threefry_dropout_error_string.restype = ctypes.c_char_p
    return lib


def threefry_keep_mask_cuda(keys: torch.Tensor, shape, keep: float,
                            offset: int = 0) -> torch.Tensor:
    """Launch ``csrc/threefry_dropout.cu`` on PyTorch's current stream; same
    contract as :func:`threefry_keep_mask_reference`. The kernel reads the
    key from ``keys``'s memory when it runs. Counts its launches in
    ``threefry_keep_mask_cuda.launches``."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_keep_mask_cuda needs a CUDA key, got {dev}")
    _check_keys(keys)
    if not keys.is_contiguous():
        raise ValueError("the key must be contiguous")
    shape = tuple(int(d) for d in shape)
    numel = math.prod(shape)
    if numel == 0 or offset < 0 or offset + numel > 2**64:
        raise ValueError(f"bad mask size {numel} at offset {offset}")
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.threefry_keep_mask_launch(keys.data_ptr(), out.data_ptr(), numel, offset,
                                            float(np.float32(keep)),
                                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.threefry_dropout_error_string(err).decode()
        raise RuntimeError(f"threefry_dropout launch failed: {msg} ({err})")
    threefry_keep_mask_cuda.launches += 1
    return out


threefry_keep_mask_cuda.launches = 0


def threefry_keep_mask(keys: torch.Tensor, shape, keep: float, offset: int = 0) -> torch.Tensor:
    """Flax's dropout keep mask of ``shape`` under ``keys`` (see the module
    docstring): the kernel for a key on the card, the plain version for a
    key on the CPU."""
    if keys.device.type == "cuda":
        return threefry_keep_mask_cuda(keys, shape, keep, offset)
    if keys.device.type == "cpu":
        return threefry_keep_mask_reference(keys, shape, keep, offset)
    raise ValueError(f"unsupported device {keys.device}")


def keys_tensor(keys: np.ndarray, device=None) -> torch.Tensor:
    """uint32 keys ``(..., 2)`` (``jax_random``'s) as the int32 tensor of
    the same bits that :func:`threefry_keep_mask` takes."""
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint32).view(np.int32)).to(device)
