"""The port's Feistel epoch shuffle against collie_tpu's: bit-equal given
JAX's keys (the four ints ``feistel_permutation`` draws from its key), and
a bijection of ``arange(n)`` when the port draws its own keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops.shuffle import feistel_permutation as jax_feistel
from collie_tpu_torch.ops.shuffle import (_mix, feistel_permutation,
                                          feistel_permutation_from_keys)


def _jax_keys(rng):
    return np.asarray(jax.random.randint(rng, (4,), 0, jnp.iinfo(jnp.int32).max,
                                         dtype=jnp.int32))


@pytest.mark.parametrize('n', [2, 3, 1000, 1024, 1025, 2 ** 17, 2 ** 17 + 1])
def test_permutation_bit_equal_to_jax(n):
    rng = jax.random.PRNGKey(n)
    expected = np.asarray(jax_feistel(rng, n))
    got = feistel_permutation_from_keys(torch.from_numpy(_jax_keys(rng).astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_mix_matches_uint32_arithmetic():
    """The int64-masked murmur mix equals uint32 arithmetic at the extremes."""
    from collie_tpu.ops.shuffle import _mix as jax_mix

    x = np.array([0, 1, 2 ** 16 - 1, 2 ** 31, 2 ** 32 - 1, 123456789], dtype=np.uint32)
    for key in (0, 1, 2 ** 31 - 2, 987654321):
        expected = np.asarray(jax_mix(jnp.asarray(x), jnp.uint32(key)))
        got = _mix(torch.from_numpy(x.astype(np.int64)), torch.tensor(key))
        np.testing.assert_array_equal(got.numpy(), expected.astype(np.int64))


@pytest.mark.parametrize('n', [2, 7, 1025, 99_991])
def test_own_keys_give_a_bijection(n):
    generator = torch.Generator().manual_seed(n)
    p = feistel_permutation(generator, n).numpy()
    assert p.shape == (n,) and p.min() == 0 and p.max() == n - 1
    assert len(np.unique(p)) == n


def test_keys_must_be_four():
    with pytest.raises(ValueError, match='4 keys'):
        feistel_permutation_from_keys(torch.arange(3), 10)
