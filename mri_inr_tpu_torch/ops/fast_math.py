"""Polynomial sines and cosines (counterpart of ``mri_inr_tpu/ops/fast_math.py``).

Same coefficients and the same range reduction as the JAX package:
``v - 2pi * floor(v / 2pi + 0.5)`` (round half up; the floor term carries no
gradient), then an odd minimax polynomial over [-pi, pi]:

- ``fast_sin``: degree 9, |err| <= 5.9e-6;
- ``fast_sin7``: degree 7, |err| <= 2.6e-4;
- ``fast_sin5``: degree 5, |err| <= 7.0e-3;
- ``fast_sin7_bf16``: degree 7 with the polynomial evaluated in bf16 (each
  operation rounded to bf16, as XLA does), range reduction in f32;
- ``fast_cos`` / ``fast_cos5``: ``fast_sin(x + pi/2)`` / ``fast_sin5(x +
  pi/2)`` in f32, the derivative partners the train kernels' backward uses.

The CUDA kernels (``ops/csrc/*.cu``) evaluate the same polynomials; these
functions are the building blocks of their plain versions and the module
path's activation.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586
INV_TWO_PI = 0.15915494309189535
HALF_PI = 1.5707963267948966

_C0 = 9.999793973572e-01
_C1 = -1.666243985636e-01
_C2 = 8.308990402314e-03
_C3 = -1.926507745066e-04
_C4 = 2.147913009143e-06

_D0 = 9.992763920561e-01
_D1 = -1.656675056348e-01
_D2 = 7.958186419379e-03
_D3 = -1.450852979995e-04

_E0 = 9.8444443e-01
_E1 = -1.5347773e-01
_E2 = 5.4669000e-03


def _bf16(c: float) -> float:
    """A coefficient rounded to bf16 (``jnp.bfloat16(c)``), as a float that a
    bf16 tensor operation takes without further rounding."""
    return float(torch.tensor(c, dtype=torch.float64).to(torch.bfloat16))


_D0_BF, _D1_BF, _D2_BF, _D3_BF = (_bf16(c) for c in (_D0, _D1, _D2, _D3))


def _reduce(x: torch.Tensor) -> torch.Tensor:
    v = x.float()
    return v - TWO_PI * torch.floor(v.detach() * INV_TWO_PI + 0.5)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Degree-9 polynomial sine, computed in f32, cast back to ``x.dtype``."""
    v = _reduce(x)
    v2 = v * v
    p = _C3 + v2 * _C4
    p = _C2 + v2 * p
    p = _C1 + v2 * p
    p = _C0 + v2 * p
    return (v * p).to(x.dtype)


def fast_sin7(x: torch.Tensor) -> torch.Tensor:
    """Degree-7 polynomial sine."""
    v = _reduce(x)
    v2 = v * v
    p = _D2 + v2 * _D3
    p = _D1 + v2 * p
    p = _D0 + v2 * p
    return (v * p).to(x.dtype)


def fast_sin5(x: torch.Tensor) -> torch.Tensor:
    """Degree-5 polynomial sine."""
    v = _reduce(x)
    v2 = v * v
    p = _E1 + v2 * _E2
    p = _E0 + v2 * p
    return (v * p).to(x.dtype)


def fast_sin7_bf16(x: torch.Tensor) -> torch.Tensor:
    """Degree-7 sine with the polynomial in bf16; returns bf16."""
    v = _reduce(x).to(torch.bfloat16)
    v2 = v * v
    p = _D2_BF + v2 * _D3_BF
    p = _D1_BF + v2 * p
    p = _D0_BF + v2 * p
    return v * p


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """Polynomial cosine, ``fast_sin(x + pi/2)`` computed in f32."""
    return fast_sin(x.float() + HALF_PI).to(x.dtype)


def fast_cos5(x: torch.Tensor) -> torch.Tensor:
    """Degree-5 polynomial cosine, ``fast_sin5(x + pi/2)`` computed in f32."""
    return fast_sin5(x.float() + HALF_PI).to(x.dtype)
