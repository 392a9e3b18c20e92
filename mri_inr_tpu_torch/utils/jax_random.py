"""The JAX package's seeded draws, on the host, in numpy: ``jax.random``'s
threefry2x32 keys and the samplers the JAX package calls, bit for bit where
the arithmetic allows (jax 0.9.0, ``jax_threefry_partitionable`` at its
default ``True``, 32-bit mode).

- :func:`key` is ``jax.random.key(seed)``: the key ``(0, seed mod 2^32)``
  (in 32-bit mode the seed is truncated to 32 bits, negative seeds too).
- :func:`fold_in` hashes ``(0, data)`` under the key; :func:`split` hashes
  the counters ``(0, i)``.
- :func:`random_bits` hashes the flat index of every element, as the pair
  (high, low) of a 64-bit counter, and returns ``x0 ^ x1``.
- :func:`uniform` puts the top 23 bits under the exponent of 1.0 and
  subtracts 1, then scales by one fused multiply-add, as XLA on the CPU
  compiles ``floats * (maxval - minval) + minval``, and clamps at
  ``minval``.
- :func:`randint` is ``jax.random.randint``'s two-draw modulus over int32.
- :func:`truncated_normal` is ``sqrt(2) * erfinv(U(erf(lo/sqrt2),
  erf(hi/sqrt2)))``. XLA evaluates ``erf`` and ``erfinv`` in float32 by
  its own polynomials; here ``erf`` is the float64 value rounded (equal to
  XLA's at the bounds the initializers use) and ``erfinv`` is Giles'
  single-precision polynomial, the one XLA uses, by fused multiply-adds, on
  a ``log1p`` computed in float64 and rounded, where XLA's own ``log1p``
  can be an ulp away. So a draw is within an ulp or two of JAX's, and
  equal to it for about 99 in 100 elements.

A key is a ``(2,)`` uint32 array, as ``jax.random.key_data`` gives it;
keys ``(..., 2)`` draw for each key what ``vmap`` over them would.
Everything runs on the CPU in numpy uint32 arithmetic, whose wrap-around is
threefry's; no Python int enters an array operation unconverted (numpy
would widen to int64). A fused multiply-add ``a * b + c`` of float32 values
is evaluated in float64 and rounded to float32: the product is exact in
float64, so this is the fused result unless the float64 sum was itself
rounded onto a float32 tie, which none of the draws the tests hold to
JAX's meets. ``log1p``, which numpy may vectorise inexactly, runs in
float64 and is rounded once.
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


_CHUNK = 1 << 16  # counters hashed at a time: the working set stays in cache


def _rounds(ks: tuple, x0: np.ndarray, x1: np.ndarray) -> None:
    """The 20 rounds and 5 key injections, in place on ``x0`` and ``x1``."""
    tmp = np.empty_like(x1)
    x0 += ks[0]
    x1 += ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, _U32(r), out=tmp)
            x1 >>= _U32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + _U32(i + 1)


def threefry2x32(k: np.ndarray, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    (uint32) under the key ``k``: one key ``(2,)``, or keys ``(..., 2)``
    whose leading shape broadcasts against the counters'."""
    k = np.asarray(k, _U32)
    ks = (k[..., 0], k[..., 1], k[..., 0] ^ k[..., 1] ^ _PARITY)
    shape = np.broadcast_shapes(ks[0].shape, np.shape(x0), np.shape(x1))
    y0 = np.array(np.broadcast_to(np.asarray(x0, _U32), shape))  # writable copies
    y1 = np.array(np.broadcast_to(np.asarray(x1, _U32), shape))
    if k.ndim > 1:
        _rounds(ks, y0, y1)
        return y0, y1
    flat0, flat1 = y0.reshape(-1), y1.reshape(-1)
    for start in range(0, flat0.size, _CHUNK):
        _rounds(ks, flat0[start : start + _CHUNK], flat1[start : start + _CHUNK])
    return y0, y1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data in 32-bit mode."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(k, data)``'s data (``data`` taken mod 2^32). An
    array of ``data``, or keys ``(..., 2)``, give the keys of every pair
    ``(..., 2)``, as ``vmap`` over ``fold_in`` would."""
    data = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(_U32)
    y0, y1 = threefry2x32(k, np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``'s data: ``(..., num, 2)`` for keys
    ``(..., 2)``."""
    k = np.asarray(k, _U32)
    y0, y1 = threefry2x32(k[..., None, :], np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([y0, y1], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32), as
    ``jax.random.bits(k, shape, uint32)``; keys ``(..., 2)`` give
    ``(..., *shape)``, one draw of ``shape`` per key."""
    k = np.asarray(k, _U32)
    shape = tuple(int(d) for d in shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    y0, y1 = threefry2x32(k if k.ndim == 1 else k[..., None, :],
                          (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (y0 ^ y1).reshape(k.shape[:-1] + shape)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (see the module docstring)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: float32
    in ``[minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def randint(k: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32; keys ``(...,
    2)`` give ``(..., *shape)``): two 32-bit draws, ``(hi mod span) * (2^32
    mod span) + lo mod span``, all mod ``span``, in uint32 arithmetic that
    wraps as XLA's does."""
    info = np.iinfo(np.int32)
    if not info.min <= minval <= info.max or not info.min <= maxval <= info.max:
        raise ValueError(f"randint bounds [{minval}, {maxval}) lie outside int32")
    keys = split(k, 2)
    higher, lower = random_bits(keys[..., 0, :], shape), random_bits(keys[..., 1, :], shape)
    span = _U32(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    multiplier = np.array([2**16], _U32) % span  # an array: wraps without a warning
    multiplier = (multiplier * multiplier) % span
    offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems, 2011), as XLA evaluates it in float32
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``erfinv`` by Giles' polynomial in fused multiply-adds,
    ``w = -log1p(-x^2)`` from float64 rounded to float32; +-inf at +-1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):  # log1p(-1) = -inf, taken care of below
        w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    central = w < np.float32(5.0)
    w = np.where(central, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(central, np.float32(_ERFINV_CENTRAL[0]), np.float32(_ERFINV_TAIL[0]))
    for c, t in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = _fma(p, w, np.where(central, np.float32(c), np.float32(t)))
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), np.copysign(np.float32(np.inf), x), out)


def _erf_f32(x: float) -> np.float32:
    return np.float32(math.erf(float(np.float32(x))))


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal(k, lower, upper, shape)`` (float32),
    within an ulp or two (see the module docstring)."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    u = uniform(k, shape, _erf_f32(lo / sqrt2), _erf_f32(hi / sqrt2))
    out = np.empty_like(u)
    flat_u, flat_out = u.reshape(-1), out.reshape(-1)
    for start in range(0, flat_u.size, _CHUNK):
        part = slice(start, start + _CHUNK)
        flat_out[part] = sqrt2 * erfinv_f32(flat_u[part])
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)
