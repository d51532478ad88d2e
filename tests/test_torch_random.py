"""The port's threefry PRNG against ``jax.random`` (bit-identical streams).

The sweep defines a run's result as a function of ``PRNGKey(seed)``, so
every call the evolution path makes must give JAX's exact bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -3]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _t(key) -> torch.Tensor:
    return torch.from_numpy(_np(key))


def test_partitionable_threefry_is_jax_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(_np(jax.random.PRNGKey(seed)),
                          R.PRNGKey(seed).numpy())


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        R.PRNGKey(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 6, 8])
def test_split(seed, num):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(_np(jax.random.split(key, num)),
                          R.split(_t(key), num).numpy())


@pytest.mark.parametrize("lead", [(4,), (3, 5)])
def test_split_batched_over_leading_axes(lead):
    keys = jax.random.split(jax.random.PRNGKey(11), int(np.prod(lead)))
    keys = keys.reshape(*lead, 2)
    fn = jax.random.split
    for _ in lead:
        fn = jax.vmap(fn)
    assert np.array_equal(_np(fn(keys)), R.split(_t(keys)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_i,n_n", [(4, 16), (16, 400), (6, 37)])
def test_randint_per_element_maxval(seed, n_i, n_n):
    key = jax.random.PRNGKey(seed)
    hi = n_i + np.arange(n_n, dtype=np.int32)
    want = jax.random.randint(key, (n_n,), 0, jnp.asarray(hi))
    got = R.randint(_t(key), (n_n,), 0, torch.from_numpy(hi))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((16,), 0, 416), ((5, 7), 3, 11),
                                         ((8,), 0, 1), ((64,), -5, 2 ** 20)])
def test_randint_scalar_bounds(seed, shape, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
    assert np.array_equal(np.asarray(want),
                          R.randint(_t(key), shape, lo, hi).numpy())


def test_randint_batched_keys():
    keys = jax.random.split(jax.random.PRNGKey(5), 6).reshape(2, 3, 2)
    hi = np.array([[5], [9], [400]], np.int32) + np.zeros((3, 7), np.int32)
    want = jax.vmap(jax.vmap(
        lambda k, h: jax.random.randint(k, (7,), 0, h)))(
            keys, jnp.broadcast_to(jnp.asarray(hi), (2, 3, 7)))
    got = R.randint(_t(keys), (7,), 0, torch.from_numpy(hi))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p,shape", [(0.004, (400, 3)), (0.05, (16,)),
                                     (0.3, (7, 5)), (0.9, (33,))])
def test_bernoulli(seed, p, shape):
    key = jax.random.PRNGKey(seed)
    want = jax.random.bernoulli(key, p, shape)
    got = R.bernoulli(_t(key), p, shape)
    assert got.dtype == torch.bool
    assert np.array_equal(np.asarray(want), got.numpy())


def test_bernoulli_batched_keys():
    keys = jax.random.split(jax.random.PRNGKey(9), 12).reshape(3, 4, 2)
    want = jax.vmap(jax.vmap(lambda k: jax.random.bernoulli(k, 0.1, (50,))))(
        keys)
    assert np.array_equal(np.asarray(want),
                          R.bernoulli(_t(keys), 0.1, (50,)).numpy())
