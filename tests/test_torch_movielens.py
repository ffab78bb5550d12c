"""The port's ``movielens`` module against collie_tpu's.

Counterparts of ``tests/test_movielens.py``.  No test reaches the network:
every test runs with ``DATA_PATH`` in ``tmp_path`` and both packages'
``_download_movielens_100k`` replaced by one that raises at once, so the
readers either fall back to the synthetic stand-ins (same seeds in both
packages) or read ML-100K-format files written to ``tmp_path`` by
``_write_movielens_100k``.  Frames and metadata are held equal with
``pd.testing.assert_frame_equal``, the visualization HTML character for
character on params copied across with ``params_from_jax``.
"""
import random
import sys
from unittest import mock

import numpy as np
import pandas as pd
import pytest

import collie_tpu.movielens.get_data as jax_get_data
import collie_tpu.movielens.visualize as jax_visualize
import collie_tpu_torch.movielens.get_data as get_data
import collie_tpu_torch.movielens.run as run_module
from collie_tpu_torch.movielens import (get_movielens_metadata, get_recommendation_visualizations,
                                        get_user_metadata, read_movielens_df,
                                        read_movielens_df_item, read_movielens_df_user)

READERS = ['df', 'df_no_decrement', 'df_item', 'df_user']


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    """Both packages read under ``tmp_path`` and cannot download."""
    for module in (get_data, jax_get_data):
        monkeypatch.setattr(module, 'DATA_PATH', tmp_path)
        monkeypatch.setattr(module, '_download_movielens_100k',
                            mock.Mock(side_effect=OSError('no network')))
    monkeypatch.delenv('COLLIE_TPU_SYNTHETIC_MOVIELENS', raising=False)
    return tmp_path


def _read(module, which, **kwargs):
    if which == 'df':
        return module.read_movielens_df(decrement_ids=True, **kwargs)
    if which == 'df_no_decrement':
        return module.read_movielens_df(decrement_ids=False, **kwargs)
    if which == 'df_item':
        return module.read_movielens_df_item(**kwargs)
    return module.read_movielens_df_user(**kwargs)


def _write_files(directory):
    """ML-100K files of the synthetic stand-ins; returns the frames written."""
    frames = (get_data._synthetic_movielens_df(decrement_ids=False),
              get_data._synthetic_movielens_df_item(), get_data._synthetic_movielens_df_user())
    get_data._write_movielens_100k(directory, *frames)
    return frames


@pytest.mark.parametrize('which', READERS)
def test_fallback_frames_equal_jax(which):
    pd.testing.assert_frame_equal(_read(get_data, which, synthetic_fallback=True),
                                  _read(jax_get_data, which, synthetic_fallback=True))


@pytest.mark.parametrize('which', READERS)
def test_environment_variable_enables_the_fallback(which, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SYNTHETIC_MOVIELENS', '1')
    pd.testing.assert_frame_equal(_read(get_data, which),
                                  _read(jax_get_data, which, synthetic_fallback=True))


@pytest.mark.parametrize('which', READERS)
def test_frames_read_from_files_equal_jax(which, offline):
    _write_files(offline)
    pd.testing.assert_frame_equal(_read(get_data, which), _read(jax_get_data, which))
    for module in (get_data, jax_get_data):
        module._download_movielens_100k.assert_not_called()


def test_files_read_back_as_written(offline):
    """The readers are the writer's inverse; ``zip`` excepted, which
    ``read_csv`` parses as integers when every zip is digits (the stand-in's
    are), so it is compared as text."""
    df, df_item, df_user = _write_files(offline)
    pd.testing.assert_frame_equal(read_movielens_df(decrement_ids=False), df)
    decremented = df.copy()
    decremented[['user_id', 'item_id']] -= 1
    pd.testing.assert_frame_equal(read_movielens_df(), decremented)
    pd.testing.assert_frame_equal(read_movielens_df_item(), df_item)
    read_user = read_movielens_df_user()
    pd.testing.assert_frame_equal(read_user.drop(columns='zip'), df_user.drop(columns='zip'))
    assert read_user['zip'].astype(str).tolist() == df_user['zip'].tolist()


@pytest.mark.parametrize('source', ['fallback', 'files'])
def test_metadata_equals_jax(source, offline):
    if source == 'files':
        _write_files(offline)
    kwargs = dict(synthetic_fallback=True)
    item = get_movielens_metadata(read_movielens_df_item(**kwargs))
    pd.testing.assert_frame_equal(
        item, jax_get_data.get_movielens_metadata(jax_get_data.read_movielens_df_item(**kwargs)))
    user = get_user_metadata(read_movielens_df_user(**kwargs))
    pd.testing.assert_frame_equal(
        user, jax_get_data.get_user_metadata(jax_get_data.read_movielens_df_user(**kwargs)))
    genre_cols = [c for c in item.columns if c.startswith('genre_')]
    assert len(genre_cols) == 19 and genre_cols[-1] == 'genre_unknown'
    assert list(user.columns[:2]) == ['age', 'gender']


@pytest.mark.parametrize('which', READERS)
def test_offline_without_fallback_raises(which):
    """Each reader raises JAX's message; ``read_movielens_df``'s names the
    synthetic fallback."""
    with pytest.raises(RuntimeError, match='MovieLens 100K') as port_error:
        _read(get_data, which, synthetic_fallback=False)
    with pytest.raises(RuntimeError) as jax_error:
        _read(jax_get_data, which, synthetic_fallback=False)
    assert str(port_error.value) == str(jax_error.value)
    if which in ('df', 'df_no_decrement'):
        assert 'synthetic' in str(port_error.value)


def test_run_movielens_example_end_to_end(offline, monkeypatch, capsys):
    """The example on the CPU with the save mocked, as JAX's test runs it
    (``tests/test_movielens.py:108``)."""
    monkeypatch.setattr(run_module, 'DATA_PATH', offline)
    with mock.patch.object(run_module.MatrixFactorizationModel, 'save_model',
                           autospec=True) as save_mock:
        run_module.run_movielens_example(epochs=1, synthetic_fallback=True, map_location='cpu')
    save_mock.assert_called_once()
    model, path = save_mock.call_args.args
    assert path == offline / 'fitted_model' / 'model.npz'
    # the device is not a hyperparameter (``test_map_location_is_not_a_hyperparameter``)
    assert 'map_location' not in model.hparams and model.device.type == 'cpu'
    assert model.hparams['dropout_p'] == 0.05 and model.hparams['embedding_dim'] == 10
    out = capsys.readouterr().out
    for name in ('AUC:', 'MRR:', 'MAP@10:'):
        line = next(line for line in out.splitlines() if line.startswith(name))
        assert 0.0 <= float(line.split()[-1]) <= 1.0


def test_cli_passes_map_location(monkeypatch):
    calls = []
    monkeypatch.setattr(run_module, 'run_movielens_example',
                        lambda **kwargs: calls.append(kwargs))
    monkeypatch.setattr(sys, 'argv', ['run', '--epochs', '2', '--map-location', 'cpu',
                                      '--synthetic-fallback'])
    run_module.main()
    assert calls == [dict(epochs=2, gpus=0, synthetic_fallback=True, map_location='cpu')]


@pytest.fixture(scope='module')
def model_pair():
    """The JAX MF on the stand-in's implicit interactions and the port's
    with its params."""
    from collie_tpu.data import Interactions as JaxInteractions
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
    from collie_tpu.utils import convert_to_implicit as jax_convert_to_implicit
    from collie_tpu_torch import Interactions, MatrixFactorizationModel, params_from_jax
    from collie_tpu_torch.utils import convert_to_implicit

    df = get_data._synthetic_movielens_df(decrement_ids=True)
    models = []
    for inter_cls, cls, convert, extra in (
            (JaxInteractions, JaxMF, jax_convert_to_implicit, {}),
            (Interactions, MatrixFactorizationModel, convert_to_implicit,
             {'map_location': 'cpu'})):
        df_imp = convert(df)
        train = inter_cls(users=df_imp['user_id'], items=df_imp['item_id'],
                          allow_missing_ids=True, check_num_negative_samples_is_valid=False)
        models.append(cls(train=train, embedding_dim=4, seed=0, **extra))
    jax_model, model = models
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    return jax_model, model


def _frames():
    df_user = get_data._synthetic_movielens_df(decrement_ids=False)
    posters = pd.DataFrame({'item_id': np.arange(1, 1683, 7),
                            'url': [f'http://example.com/{i}.jpg' for i in range(1, 1683, 7)]})
    return df_user, get_data._synthetic_movielens_df_item(), posters


@pytest.mark.parametrize('detailed', [False, True])
@pytest.mark.parametrize('filter_films', [True, False])
@pytest.mark.parametrize('user_id', [1, 17])
def test_visualization_html_equals_jax(model_pair, detailed, filter_films, user_id):
    jax_model, model = model_pair
    df_user, df_item, posters = _frames()
    kwargs = dict(user_id=user_id, df_user=df_user, df_item=df_item,
                  movielens_posters_df=posters, detailed=detailed, filter_films=filter_films,
                  shuffle=False, num_similar_movies=8, image_width=120)
    html = get_recommendation_visualizations(model, **kwargs)
    assert html == jax_visualize.get_recommendation_visualizations(jax_model, **kwargs)
    assert f'<h3>User {user_id}:</h3>' in html and 'Recommended films:' in html
    assert ('has rated' in html) == detailed


def test_shuffled_visualization_equals_jax_under_one_seed(model_pair):
    jax_model, model = model_pair
    df_user, df_item, posters = _frames()
    kwargs = dict(user_id=5, df_user=df_user, df_item=df_item, movielens_posters_df=posters)
    random.seed(3)
    html = get_recommendation_visualizations(model, **kwargs)
    random.seed(3)
    assert html == jax_visualize.get_recommendation_visualizations(jax_model, **kwargs)


@pytest.mark.parametrize('bad', ['df_user', 'df_item'])
def test_visualization_needs_one_based_ids_as_jax(model_pair, bad):
    jax_model, model = model_pair
    df_user, df_item, posters = _frames()
    if bad == 'df_user':
        df_user = get_data._synthetic_movielens_df(decrement_ids=True)
    else:
        df_item = df_item.assign(item_id=df_item['item_id'] - 1)
    kwargs = dict(user_id=1, df_user=df_user, df_item=df_item, movielens_posters_df=posters)
    with pytest.raises(ValueError, match='start at ``1``') as port_error:
        get_recommendation_visualizations(model, **kwargs)
    with pytest.raises(ValueError) as jax_error:
        jax_visualize.get_recommendation_visualizations(jax_model, **kwargs)
    assert str(port_error.value) == str(jax_error.value)


def test_reference_tool_writes_the_same_files(tmp_path):
    """``tools/movielens_jax_reference.py`` (collie_tpu's example on the
    files ``chip_smoke.py`` phase 12 trains on) writes the bytes the port's
    writer writes."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / 'tools' / 'movielens_jax_reference.py'
    spec = importlib.util.spec_from_file_location('movielens_jax_reference', path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    theirs = tool.write_files(tmp_path / 'jax')
    _write_files(tmp_path / 'port')
    ours = tmp_path / 'port' / 'ml-100k'
    for name in ('u.data', 'u.item', 'u.user'):
        assert (theirs / name).read_bytes() == (ours / name).read_bytes(), name
