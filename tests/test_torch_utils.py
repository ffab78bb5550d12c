"""The port's numpy-only data-prep helpers against collie_tpu's on seeded
frames: ratings matrices, DataFrame -> ``Interactions``, user filtering,
truncated-normal init, HTML rendering and the timer must give equal
results."""
import numpy as np
import pandas as pd
import pytest

import collie_tpu.utils as jax_utils
import collie_tpu_torch
from collie_tpu_torch import utils


@pytest.fixture
def df():
    rng = np.random.default_rng(3)
    return pd.DataFrame({'user_id': rng.integers(0, 30, 400),
                         'item_id': rng.integers(0, 50, 400),
                         'rating': rng.integers(1, 6, 400)}).drop_duplicates(
        subset=['user_id', 'item_id']).reset_index(drop=True)


@pytest.mark.parametrize('sparse', [False, True])
def test_create_ratings_matrix(df, sparse):
    out = utils.create_ratings_matrix(df, sparse=sparse)
    ref = jax_utils.create_ratings_matrix(df, sparse=sparse)
    if sparse:
        out, ref = out.toarray(), ref.toarray()
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match='must start at 0'):
        utils.create_ratings_matrix(df.assign(user_id=df['user_id'] + 1))


@pytest.mark.parametrize('ratings_col', ['rating', None])
def test_df_to_interactions(df, ratings_col):
    out = utils.df_to_interactions(df, ratings_col=ratings_col, num_negative_samples=2)
    ref = jax_utils.df_to_interactions(df, ratings_col=ratings_col, num_negative_samples=2)
    assert type(out).__module__.startswith('collie_tpu_torch')
    np.testing.assert_array_equal(out.mat.toarray(), ref.mat.toarray())
    assert out.num_negative_samples == ref.num_negative_samples == 2


@pytest.mark.parametrize('n', [1, 10, 15])
def test_remove_users_with_fewer_than_n_interactions(df, n):
    pd.testing.assert_frame_equal(utils.remove_users_with_fewer_than_n_interactions(df, n),
                                  jax_utils.remove_users_with_fewer_than_n_interactions(df, n))


def test_trunc_normal():
    out = utils.trunc_normal((40, 8), mean=0.5, std=0.1, seed=4)
    np.testing.assert_array_equal(out, jax_utils.trunc_normal((40, 8), mean=0.5, std=0.1,
                                                              seed=4))
    assert out.dtype == np.float32 and np.abs(out - 0.5).max() <= 0.2


def test_df_to_html(df):
    frame = df.head(5).assign(image='a.png', link='http://example.com')
    kwargs = dict(image_cols='image', hyperlink_cols=['link', 'image'],
                  html_tags={'rating': ['b', 'i']}, image_width=30, max_num_rows=3)
    assert utils.df_to_html(frame, **kwargs) == jax_utils.df_to_html(frame, **kwargs)
    assert utils.df_to_html(frame, transpose=True) == jax_utils.df_to_html(frame, transpose=True)
    with pytest.raises(ValueError, match='not a column'):
        utils.df_to_html(frame, image_cols='missing')


def test_timer(capsys, monkeypatch):
    now = [100.0]
    monkeypatch.setattr(utils.time, 'time', lambda: now[0])
    timer = utils.Timer()
    now[0] += 90
    assert timer.timecheck('step') == 1.5
    now[0] += 30
    assert timer.time_since_start() == 2.0
    assert capsys.readouterr().out == 'step (1.50 min)\nTotal time: 2.00 min\n'


@pytest.mark.parametrize('name', ['create_ratings_matrix', 'df_to_interactions', 'df_to_html',
                                  'remove_users_with_fewer_than_n_interactions',
                                  'trunc_normal', 'Timer'])
def test_helpers_are_exported_flat(name):
    assert name in collie_tpu_torch.__all__
    assert getattr(collie_tpu_torch, name) is getattr(utils, name)
