"""The port's polynomial sines against the JAX package's, on the same numpy
inputs. The range reduction and the polynomials are the same operations in
the same order, so f32 results agree to the last bit in practice; the stated
bar is 1e-6 (and one bf16 ulp for the bf16 variant)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.ops import fast_math as jfm
from mri_inr_tpu_torch.ops import fast_math as tfm

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

X = np.concatenate([
    np.random.default_rng(0).uniform(-1e3, 1e3, 200_000),
    np.linspace(-10.0, 10.0, 200_001),
]).astype(np.float32)

FUNCS = ["fast_sin", "fast_sin7", "fast_sin5"]


@pytest.mark.parametrize("name", FUNCS)
def test_f32_sines_match_jax(name):
    want = np.asarray(getattr(jfm, name)(jnp.asarray(X)))
    got = getattr(tfm, name)(torch.from_numpy(X)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bf16_sine_matches_jax_within_one_ulp():
    want = np.asarray(jfm.fast_sin7_bf16(jnp.asarray(X))).astype(np.float32)
    got = tfm.fast_sin7_bf16(torch.from_numpy(X))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.maximum(np.abs(want), 2.0**-126) * 2.0**-7  # bf16: 8-bit mantissa
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("name", FUNCS)
def test_sines_keep_input_dtype_and_are_accurate(name):
    x = torch.linspace(-50.0, 50.0, 10001)
    bound = {"fast_sin": 5e-5, "fast_sin7": 3e-4, "fast_sin5": 7.5e-3}[name]
    got = getattr(tfm, name)(x)
    assert got.dtype == torch.float32
    assert (got.double() - torch.sin(x.double())).abs().max() < bound
    assert getattr(tfm, name)(x.bfloat16()).dtype == torch.bfloat16


def test_range_reduction_carries_no_gradient():
    """d fast_sin / dx ~ cos(x) and equals JAX's gradient: the floor term is
    constant for autograd."""
    x = torch.linspace(-20.0, 20.0, 4001, requires_grad=True)
    tfm.fast_sin(x).sum().backward()
    want = jax.vmap(jax.grad(jfm.fast_sin))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    core = np.abs(x.detach().numpy()) <= 3.0
    np.testing.assert_allclose(x.grad.numpy()[core], np.cos(x.detach().numpy()[core]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["fast_cos", "fast_cos5"])
def test_cosines_match_jax_bit_for_bit(name):
    """``fast_sin(x + pi/2)`` in f32 on both sides: the same operations in
    the same order, so the 4e5 results are identical."""
    want = np.asarray(getattr(jfm, name)(jnp.asarray(X)))
    got = getattr(tfm, name)(torch.from_numpy(X)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,bound", [("fast_cos", 5e-5), ("fast_cos5", 7.5e-3)])
def test_cosines_keep_input_dtype_and_are_accurate(name, bound):
    x = torch.linspace(-50.0, 50.0, 10001)
    got = getattr(tfm, name)(x)
    assert got.dtype == torch.float32
    assert (got.double() - torch.cos(x.double())).abs().max() < bound
    assert getattr(tfm, name)(x.bfloat16()).dtype == torch.bfloat16
