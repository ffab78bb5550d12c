"""The port's degree-bucketed complement sampler against collie_tpu's.

The host-side table builders must be bit-equal; given JAX's uniforms
(``jax.random.uniform(rng, (N_g, K + 2 * dedup_rounds))``) the grouped
sampler must return identical negatives, padding and dedup included; and
the invariants of ``tests/test_device_sampling.py`` (never a positive,
uniform over the complement, pad positions repeat the first, dedup reduces
duplicates) hold for the port on its own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix

import collie_tpu.ops.device_sampling as J
from collie_tpu_torch.ops import device_sampling as T


@pytest.fixture(scope='module')
def skewed_problem():
    """Degrees spanning several power-of-two buckets, incl. exact boundary
    degrees (127/128/129) and one heavy user (``tests/test_device_sampling.py``)."""
    rng = np.random.default_rng(5)
    num_users, num_items = 40, 700
    degrees = rng.integers(1, 60, num_users)
    degrees[0], degrees[1], degrees[2], degrees[3] = 400, 129, 128, 127
    rows, cols = [], []
    for u, d in enumerate(degrees):
        rows.extend([u] * d)
        cols.extend(rng.choice(num_items, size=d, replace=False).tolist())
    mat = coo_matrix((np.ones(len(rows)), (np.asarray(rows), np.asarray(cols))),
                     shape=(num_users, num_items))
    return mat, np.asarray(rows, dtype=np.int32), num_items


def _torch_tables(tables):
    specs, counts, users_g, pos_of = tables
    return (tuple((torch.from_numpy(r), torch.from_numpy(t)) for r, t in specs),
            torch.from_numpy(counts), torch.from_numpy(users_g), torch.from_numpy(pos_of))


@pytest.mark.parametrize('chunk', [256, 8192])
def test_bucketed_tables_bit_equal(skewed_problem, chunk):
    mat, ex_rows, _ = skewed_problem
    ref = J.build_bucketed_complement_tables(mat, ex_rows, chunk=chunk)
    got = T.build_bucketed_complement_tables(mat, ex_rows, chunk=chunk)
    assert len(got[0]) == len(ref[0]) >= 3
    for (r1, t1), (r2, t2) in zip(ref[0], got[0]):
        np.testing.assert_array_equal(r2, r1)
        np.testing.assert_array_equal(t2, t1)
        assert r2.dtype == r1.dtype and t2.dtype == t1.dtype
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype
    assert T.bucketed_table_bytes(mat) == J.bucketed_table_bytes(mat)


@pytest.mark.parametrize('K,dedup_rounds', [(8, 0), (8, 1), (3, 2), (1, 1)])
def test_grouped_sampler_identical_given_jax_uniforms(skewed_problem, K, dedup_rounds):
    mat, ex_rows, num_items = skewed_problem
    tables = J.build_bucketed_complement_tables(mat, ex_rows, chunk=256)
    specs, counts, users_g, _ = tables
    rng = jax.random.PRNGKey(K * 10 + dedup_rounds)
    expected = np.asarray(J.complement_sample_negatives_bucketed_grouped_impl(
        rng, jnp.asarray(users_g), tuple((jnp.asarray(r), jnp.asarray(t)) for r, t in specs),
        jnp.asarray(counts), num_items, K, dedup_rounds=dedup_rounds, chunk=256))
    u01 = np.array(jax.random.uniform(rng, (len(users_g), K + 2 * dedup_rounds)))
    t_specs, t_counts, t_users_g, _ = _torch_tables(tables)
    got = T.complement_sample_negatives_bucketed_grouped(
        torch.from_numpy(u01), t_users_g, t_specs, t_counts, num_items, K,
        dedup_rounds=dedup_rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)


def test_reorder_wrapper_identical_given_jax_uniforms(skewed_problem):
    mat, ex_rows, num_items = skewed_problem
    tables = J.build_bucketed_complement_tables(mat, ex_rows, chunk=256)
    specs, counts, users_g, pos_of = tables
    n = len(ex_rows)
    idx = np.concatenate([np.random.default_rng(3).permutation(n), np.zeros(5, np.int64)])
    idx[n:] = idx[0]
    rng = jax.random.PRNGKey(2)
    expected = np.asarray(J.complement_sample_negatives_bucketed_impl(
        rng, jnp.asarray(idx.astype(np.int32)), jnp.asarray(pos_of), jnp.asarray(users_g),
        tuple((jnp.asarray(r), jnp.asarray(t)) for r, t in specs), jnp.asarray(counts),
        num_items, 8, chunk=256))
    u01 = np.array(jax.random.uniform(rng, (len(users_g), 10)))
    t_specs, t_counts, t_users_g, t_pos_of = _torch_tables(tables)
    got = T.complement_sample_negatives_bucketed(
        torch.from_numpy(u01), torch.from_numpy(idx), t_pos_of, t_users_g, t_specs,
        t_counts, num_items, 8)
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy()[n:], np.tile(got.numpy()[:1], (5, 1)))


def test_searchsorted_count_equals_the_comparison_count(skewed_problem):
    """``searchsorted(right=True)`` on a sorted table row, padding
    (``num_items``) included, is the JAX version's ``sum(row <= r)``."""
    mat, ex_rows, num_items = skewed_problem
    specs, *_ = T.build_bucketed_complement_tables(mat, ex_rows, chunk=256)
    rng = np.random.default_rng(0)
    for row_idx, table in specs:
        rows = torch.from_numpy(table[row_idx])
        r = torch.from_numpy(rng.integers(0, num_items + 1, (len(row_idx), 12))
                             .astype(np.int32))
        expected = (rows[:, None, :] <= r[:, :, None]).sum(-1).to(torch.int32)
        torch.testing.assert_close(T.count_at_or_below(rows, r), expected, rtol=0, atol=0)


def _sample(mat, ex_rows, num_items, K, dedup_rounds=1, seed=0, idx=None):
    specs, counts, users_g, pos_of = _torch_tables(
        T.build_bucketed_complement_tables(mat, ex_rows, chunk=256))
    generator = torch.Generator().manual_seed(seed)
    u01 = torch.rand((len(users_g), K + T.SPARES_PER_ROUND * dedup_rounds), generator=generator)
    if idx is None:
        idx = torch.arange(len(ex_rows))
    return T.complement_sample_negatives_bucketed(u01, idx, pos_of, users_g, specs, counts,
                                                  num_items, K, dedup_rounds).numpy()


def test_port_draws_never_hit_positives_and_are_uniform(skewed_problem):
    mat, ex_rows, num_items = skewed_problem
    positives = set(zip(mat.row.tolist(), mat.col.tolist()))
    negs = _sample(mat, ex_rows, num_items, 8, seed=2)
    assert negs.min() >= 0 and negs.max() < num_items
    assert not any((int(u), int(i)) in positives for u, row in zip(ex_rows, negs) for i in row)
    # the heavy user (degree 400 of 700): every complement item in a sane band
    draws = negs[ex_rows == 0].reshape(-1)
    freq = np.bincount(draws, minlength=num_items)
    comp = np.setdiff1d(np.arange(num_items), mat.tocsr()[0].indices)
    assert freq[np.setdiff1d(np.arange(num_items), comp)].sum() == 0
    assert freq[comp].max() <= len(draws) / len(comp) * 6 + 10


def test_port_dedup_reduces_duplicates(skewed_problem):
    mat, ex_rows, num_items = skewed_problem
    dups = [sum(len(row) - len(np.unique(row))
                for row in _sample(mat, ex_rows, num_items, 8, rounds, seed=4))
            for rounds in (0, 1)]
    assert dups[1] < dups[0]


def test_uniforms_of_the_wrong_shape_raise(skewed_problem):
    mat, ex_rows, num_items = skewed_problem
    specs, counts, users_g, _ = _torch_tables(
        T.build_bucketed_complement_tables(mat, ex_rows, chunk=256))
    with pytest.raises(ValueError, match='u01 must be'):
        T.complement_sample_negatives_bucketed_grouped(
            torch.rand(len(users_g), 8), users_g, specs, counts, num_items, 8, dedup_rounds=1)
