"""gs2pc_torch.ops.prng against jax.random (threefry2x32 under
jax_threefry_partitionable, JAX's default): keys, splits, random words and
uniforms bit for bit, normals within NORMAL_ATOL, and a block of any draw
equal to the same slice of the whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2pc_torch.ops import prng

SEEDS = [0, 7, 2**31 + 5]
N = 3000
# XLA's float32 log1p and torch's round apart on ~5% of the normals, by a
# few ulps (2.4e-7 at |z| < 2, 4.8e-7 at |z| in [2, 4)).
NORMAL_ATOL = 5e-7


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_partitionable_threefry_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jax.random.PRNGKey(seed)), key.numpy())
    np.testing.assert_array_equal(_words(jax.random.split(jax.random.PRNGKey(seed))),
                                  prng.split(key).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed):
    jkey, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jax.random.bits(jkey, (N,), dtype=jnp.uint32)),
                                  prng.random_bits(key, 0, N).numpy())
    ju = np.asarray(jax.random.uniform(jkey, (N,), dtype=jnp.float32))
    np.testing.assert_array_equal(ju.view(np.int32), prng.uniform(key, 0, N).numpy().view(np.int32))
    # jax.random.normal's interval, scaled and shifted in float32.
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    jv = np.asarray(jax.random.uniform(jkey, (N,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(jv.view(np.int32),
                                  prng.uniform(key, 0, N, lo, 1.0).numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (N // 3, 3), jnp.float32))
    tn = prng.normal(prng.PRNGKey(seed), 0, N).view(-1, 3).numpy()
    np.testing.assert_allclose(tn, jn, rtol=0, atol=NORMAL_ATOL)
    assert (tn == jn).mean() > 0.9


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 1), (1234, 2345), (2999, 3000)])
def test_block_equals_slice_of_the_whole(seed, lo, hi):
    key = prng.PRNGKey(seed)
    for draw in (prng.random_bits, prng.uniform, prng.normal):
        whole, part = draw(key, 0, N), draw(key, lo, hi)
        assert torch.equal(part, whole[lo:hi]), draw.__name__


def test_counters_above_two_to_the_32():
    """Normals of slots past 1.4G sit at counters >= 2^32: the high word is
    kept, as in JAX's iota_2x32_shape; threefry2x32 against JAX's own
    primitive on such counters."""
    from jax.extend.random import threefry2x32_p

    key = prng.PRNGKey(2**31 + 5)
    lo = (1 << 32) - 2
    i = np.arange(lo, lo + 4, dtype=np.int64) + np.array([0, 0, 0, 5 << 32])
    hi_w, lo_w = (i >> 32).astype(np.uint32), (i & 0xFFFFFFFF).astype(np.uint32)
    k = np.asarray(jax.random.PRNGKey(2**31 + 5))
    j0, j1 = threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(hi_w),
                                 jnp.asarray(lo_w))
    x0, x1 = prng.threefry2x32(key.tolist(), torch.tensor(i >> 32), torch.tensor(i & 0xFFFFFFFF))
    np.testing.assert_array_equal(_words(j0), x0.numpy())
    np.testing.assert_array_equal(_words(j1), x1.numpy())
    words = prng.random_bits(key, lo, lo + 3)
    np.testing.assert_array_equal(words.numpy(), (_words(j0) ^ _words(j1))[:3])
