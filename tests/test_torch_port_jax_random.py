"""The port's host-side ``jax.random`` (``mri_inr_tpu_torch/utils/jax_random.py``)
against jax 0.9.0's own draws on the CPU (``jax_threefry_partitionable`` at
its default, 32-bit mode).

- ``key``, ``fold_in`` (1,000 values a seed), ``split``, the random bits,
  ``uniform`` with and without bounds and ``randint`` equal JAX's bit for
  bit, at seeds 0, 1, 31415, 2^31 + 5 and 2^32 - 1 and shapes up to 10^6;
  a batch of keys gives what ``vmap`` over them gives.
- ``truncated_normal(-2, 2)`` over 10^6 samples lies within 1e-6 of JAX's
  draw; 99.06% of the samples are bit-exact (measured at ``key(1234)``; max
  2.4e-7): XLA's float32 ``log1p`` inside ``erfinv`` is an ulp away from
  the correctly rounded one the port uses for about one sample in eleven,
  which moves the result for about one in a hundred.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mri_inr_tpu_torch.utils import jax_random as jr

SEEDS = [0, 1, 31415, 2**31 + 5, 2**32 - 1]
SHAPES = [(1,), (7,), (3, 5), (1_000_000,)]


def _data(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 3])
def test_key_fold_in_and_split_equal_jax(seed):
    key = jax.random.key(seed)
    k = jr.key(seed)
    np.testing.assert_array_equal(k, _data(key))
    data = np.concatenate([np.arange(990), [2**31, 2**32 - 1, 12345678, 7, 2**16,
                                            2**24 + 1, 99991, 3, 2**30, 2**32 - 2]])
    assert len(data) == 1000
    want = _data(jax.vmap(lambda d: jax.random.fold_in(key, d))(jnp.asarray(data, jnp.uint32)))
    np.testing.assert_array_equal(jr.fold_in(k, data), want)
    np.testing.assert_array_equal(jr.fold_in(k, 7), _data(jax.random.fold_in(key, 7)))
    np.testing.assert_array_equal(jr.split(k, 5), _data(jax.random.split(key, 5)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_randint_equal_jax(seed, shape):
    key, k = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(jr.random_bits(k, shape),
                                  np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    for bounds in [(), (-0.0625, 0.0625), (-(6 / 256) ** 0.5, (6 / 256) ** 0.5),
                   (-0.5, 2.0)]:
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, *bounds))
        got = jr.uniform(k, shape, *bounds)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=bounds)
    for lo, hi in [(0, 2**23), (-7, 1000), (0, 3)]:
        want = np.asarray(jax.random.randint(key, shape, lo, hi))
        np.testing.assert_array_equal(jr.randint(k, shape, lo, hi), want)


def test_a_batch_of_keys_is_vmap():
    key, k = jax.random.key(5), jr.key(5)
    steps = np.arange(64)
    jkeys = jax.vmap(lambda s: jax.random.fold_in(key, s))(jnp.asarray(steps))
    keys = jr.fold_in(k, steps)
    np.testing.assert_array_equal(keys, _data(jkeys))
    np.testing.assert_array_equal(jr.split(keys, 3), _data(jax.vmap(jax.random.split,
                                                                    (0, None))(jkeys, 3)))
    want = np.asarray(jax.vmap(lambda kk: jax.random.randint(kk, (2,), 0, 2**23))(jkeys))
    np.testing.assert_array_equal(jr.randint(keys, (2,), 0, 2**23), want)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (5,)))(jkeys))
    np.testing.assert_array_equal(jr.uniform(keys, (5,)), want)


def test_truncated_normal_is_within_1e6_of_jax():
    n = 1_000_000
    want = np.asarray(jax.random.truncated_normal(jax.random.key(1234), -2.0, 2.0, (n,)))
    got = jr.truncated_normal(jr.key(1234), -2.0, 2.0, (n,))
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.abs(got - want).max() <= 1e-6
    assert np.mean(got == want) > 0.98  # measured 0.990636
    assert -2.0 < got.min() and got.max() < 2.0
    # the polynomial itself, over the open interval the draw feeds it
    x = np.linspace(-0.9999, 0.9999, 20001, dtype=np.float32)
    np.testing.assert_allclose(jr.erfinv_f32(x), np.asarray(jax.scipy.special.erfinv(x)),
                               rtol=2e-6, atol=0)
    assert jr.erfinv_f32(np.float32([1.0]))[0] == np.inf


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="outside int32"):
        jr.randint(jr.key(0), (1,), 0, 2**31)
