"""The port's numpy data layer against ``collie_tpu.data``: same seed, same
arrays bit for bit, same error types and strings."""
import warnings

import numpy as np
import pytest

import collie_tpu.data as jdata
import collie_tpu.utils as jutils
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu.data.synthetic import generate_interactions_df as jax_generate_df
import collie_tpu_torch.data as tdata
import collie_tpu_torch.utils as tutils
from collie_tpu_torch.data.synthetic import generate_implicit_interactions as torch_generate
from collie_tpu_torch.data.synthetic import generate_interactions_df as torch_generate_df


def _assert_same_interactions(a, b):
    assert type(a).__name__ == type(b).__name__
    for attr in ('row', 'col', 'data'):
        x, y = getattr(a.mat, attr), getattr(b.mat, attr)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.mat.shape == b.mat.shape
    for attr in ('num_users', 'num_items', 'num_interactions', 'min_rating', 'max_rating'):
        assert getattr(a, attr) == getattr(b, attr)
    if hasattr(a, 'positive_keys'):
        np.testing.assert_array_equal(a.positive_keys, b.positive_keys)
        assert a.num_negative_samples == b.num_negative_samples
        assert a.seed == b.seed


@pytest.fixture(scope='module')
def implicit_pair():
    kwargs = dict(num_users=80, num_items=150, num_interactions=4000, seed=11)
    return jax_generate(**kwargs), torch_generate(**kwargs)


def test_generate_implicit_interactions_bit_equal(implicit_pair):
    _assert_same_interactions(*implicit_pair)


@pytest.mark.parametrize('affinity_bias', [0.0, 1.5])
def test_generate_interactions_df_bit_equal(affinity_bias):
    kwargs = dict(num_users=50, num_items=90, num_interactions=1500,
                  affinity_bias=affinity_bias, seed=4)
    a, b = jax_generate_df(**kwargs), torch_generate_df(**kwargs)
    assert list(a.columns) == list(b.columns)
    for col in a.columns:
        np.testing.assert_array_equal(a[col].values, b[col].values)


@pytest.mark.parametrize('val_p', [0.0, 0.1])
def test_stratified_split_bit_equal(implicit_pair, val_p):
    a = jdata.stratified_split(implicit_pair[0], val_p=val_p, test_p=0.2, seed=3,
                               force_split=True)
    b = tdata.stratified_split(implicit_pair[1], val_p=val_p, test_p=0.2, seed=3,
                               force_split=True)
    assert len(a) == len(b) == (3 if val_p else 2)
    for x, y in zip(a, b):
        _assert_same_interactions(x, y)


@pytest.mark.parametrize('val_p', [0.0, 0.15])
def test_random_split_bit_equal(implicit_pair, val_p):
    a = jdata.random_split(implicit_pair[0], val_p=val_p, test_p=0.25, seed=9)
    b = tdata.random_split(implicit_pair[1], val_p=val_p, test_p=0.25, seed=9)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _assert_same_interactions(x, y)


def test_explicit_split_bit_equal():
    df = jax_generate_df(num_users=40, num_items=70, num_interactions=900, seed=2)
    kwargs = dict(users=df['user_id'].values, items=df['item_id'].values,
                  ratings=df['rating'].values, allow_missing_ids=True)
    a = jdata.stratified_split(jdata.ExplicitInteractions(**kwargs), seed=5, force_split=True)
    b = tdata.stratified_split(tdata.ExplicitInteractions(**kwargs), seed=5, force_split=True)
    for x, y in zip(a, b):
        _assert_same_interactions(x, y)


def test_duplicate_pairs_keep_the_last_value():
    users = np.array([0, 1, 0, 2, 1, 0, 2])
    items = np.array([1, 0, 1, 2, 0, 1, 0])
    ratings = np.array([5, 4, 3, 2, 1, 4, 5])
    for remove in (True, False):
        kwargs = dict(users=users, items=items, ratings=ratings,
                      remove_duplicate_user_item_pairs=remove)
        _assert_same_interactions(jdata.ExplicitInteractions(**kwargs),
                                  tdata.ExplicitInteractions(**kwargs))


def test_zero_ratings_filtered_with_the_same_warning():
    kwargs = dict(users=[0, 1, 2, 2], items=[0, 1, 2, 0], ratings=[1, 0, 1, 1],
                  num_negative_samples=1, allow_missing_ids=True, num_items=6, seed=0)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter('always')
        a = jdata.Interactions(**kwargs)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter('always')
        b = tdata.Interactions(**kwargs)
    assert [str(w.message) for w in jw] == [str(w.message) for w in tw]
    _assert_same_interactions(a, b)


def test_loader_batches_bit_equal(implicit_pair):
    for shuffle in (False, True):
        a = jdata.InteractionsDataLoader(implicit_pair[0], batch_size=512, shuffle=shuffle)
        b = tdata.InteractionsDataLoader(implicit_pair[1], batch_size=512, shuffle=shuffle)
        assert len(a) == len(b)
        for batch_a, batch_b in zip(a, b):
            assert batch_a.keys() == batch_b.keys()
            for key in batch_a:
                np.testing.assert_array_equal(batch_a[key], batch_b[key])


def test_convert_to_implicit_equal():
    df = jax_generate_df(num_users=30, num_items=40, num_interactions=600, seed=8)
    a, b = jutils.convert_to_implicit(df), tutils.convert_to_implicit(df)
    assert a.equals(b)


def _message(make):
    try:
        make()
    except (AssertionError, ValueError, TypeError, AttributeError) as err:
        return type(err).__name__, str(err)
    raise AssertionError('expected an error')


ERROR_CASES = {
    'length_mismatch': lambda d: d.Interactions(users=[0, 1], items=[0]),
    'missing_user_ids': lambda d: d.Interactions(users=[0, 2], items=[0, 1],
                                                 num_negative_samples=1),
    'missing_item_ids': lambda d: d.ExplicitInteractions(users=[0, 1], items=[0, 3],
                                                         ratings=[1, 2]),
    'ratings_length': lambda d: d.ExplicitInteractions(users=[0, 1], items=[0, 1],
                                                       ratings=[1]),
    'explicit_without_ratings': lambda d: d.ExplicitInteractions(users=[0], items=[0]),
    'bad_num': lambda d: d.Interactions(users=[0, 1], items=[0, 1], num_users='many'),
    'too_many_negatives': lambda d: d.Interactions(users=[0, 1, 1], items=[0, 1, 0],
                                                   num_negative_samples=5),
    'no_users_or_mat': lambda d: d.Interactions(items=[0, 1]),
    'bad_split_p': lambda d: d.random_split(
        d.Interactions(users=[0, 1], items=[0, 1], num_negative_samples=1,
                       check_num_negative_samples_is_valid=False), test_p=1.0),
    'single_interaction_users': lambda d: d.stratified_split(
        d.Interactions(users=[0, 1, 1], items=[0, 1, 0], num_negative_samples=1,
                       check_num_negative_samples_is_valid=False), seed=1),
    'explicit_negatives': lambda d: d.ExplicitInteractions(
        users=[0], items=[0], ratings=[1]).num_negative_samples,
}


@pytest.mark.parametrize('case', sorted(ERROR_CASES))
def test_error_types_and_strings_equal(case):
    make = ERROR_CASES[case]
    assert _message(lambda: make(jdata)) == _message(lambda: make(tdata))
