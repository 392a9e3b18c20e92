"""Threefry-2x32 draws as ``jax.random`` makes them (32-bit mode, the
partitionable bit layout), written out from the algorithm's description
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011) and
JAX's documented key handling. The program under test derives its masks,
dropout seeds and dropout keys from such draws; the reference works them out
again here.

- :func:`key`, :func:`fold_in`, :func:`split`: key data as ``(2,)`` uint32.
- :func:`random_bits`: element ``n`` hashes the counter pair ``(n >> 32,
  n & 0xffffffff)``; its bits are ``x0 ^ x1``.
- :func:`uniform`: the top 23 bits under the exponent of 1.0, less 1.
- :func:`randint`: two draws, ``(hi mod span) * (2^32 mod span) + lo mod
  span``, all mod ``span``.
- :func:`bits_torch`: :func:`random_bits` of one key over a flat range, in
  int64 tensor operations (for masks of tens of millions of elements on the
  card).
- :func:`flax_static`: the integer Flax folds in for a scope path (the first
  four bytes of the SHA-1 of its parts).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def hash2x32(k: np.ndarray, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, of counter pairs under key(s) ``k`` (``(...,
    2)``, broadcast against the counters)."""
    k = np.asarray(k, _U32)
    ks = (k[..., 0], k[..., 1], k[..., 0] ^ k[..., 1] ^ _U32(_PARITY))
    shape = np.broadcast_shapes(ks[0].shape, np.shape(x0), np.shape(x1))
    a = np.array(np.broadcast_to(np.asarray(x0, _U32), shape), ndmin=1)
    b = np.array(np.broadcast_to(np.asarray(x1, _U32), shape), ndmin=1)
    with np.errstate(over="ignore"):  # uint32 wrap-around is the hash's arithmetic
        a, b = a + ks[0], b + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = (b << _U32(r)) | (b >> _U32(32 - r))
                b = b ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a.reshape(shape), b.reshape(shape)


def key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & _M32], _U32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    data = (np.asarray(data, np.int64) & _M32).astype(_U32)
    a, b = hash2x32(k, np.zeros_like(data), data)
    return np.stack([a, b], axis=-1)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    k = np.asarray(k, _U32)
    a, b = hash2x32(k[..., None, :], np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    k = np.asarray(k, _U32)
    shape = tuple(int(d) for d in shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    a, b = hash2x32(k if k.ndim == 1 else k[..., None, :],
                    (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(_M32)).astype(_U32))
    return (a ^ b).reshape(k.shape[:-1] + shape)


def uniform(k: np.ndarray, shape) -> np.ndarray:
    bits = (random_bits(k, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(k: np.ndarray, minval: int, maxval: int) -> np.ndarray:
    """One int32 draw in ``[minval, maxval)`` per key of ``k`` (``(..., 2)``)."""
    keys = split(k, 2)
    hi, lo = random_bits(keys[..., 0, :], ()), random_bits(keys[..., 1, :], ())
    span = maxval - minval
    mult = _U32((2**16 % span) ** 2 % span)  # 2^32 mod span
    span = _U32(span)
    with np.errstate(over="ignore"):
        off = ((hi % span) * mult + lo % span) % span
    return np.int32(minval) + off.astype(np.int32)


def bits_torch(k: np.ndarray, numel: int, offset: int, device) -> torch.Tensor:
    """(numel,) int64 holding :func:`random_bits` of key ``k`` for the flat
    elements ``offset .. offset + numel - 1``."""
    k0, k1 = int(k[0]), int(k[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    idx = torch.arange(offset, offset + numel, dtype=torch.int64, device=device)
    a = ((idx >> 32) + ks[0]) & _M32
    b = ((idx & _M32) + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = b ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a ^ b


def keep_mask_torch(k: np.ndarray, shape, keep: float, device) -> torch.Tensor:
    """``bernoulli(k, keep, shape)``: ``uniform < float32(keep)``."""
    bits = bits_torch(k, math.prod(shape), 0, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (floats < float(np.float32(keep))).reshape(shape)


def flax_static(*parts) -> int:
    m = hashlib.sha1()
    for p in parts:
        m.update(p.encode() if isinstance(p, str)
                 else int(p).to_bytes((int(p).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")
