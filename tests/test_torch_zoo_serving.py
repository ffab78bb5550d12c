"""The port's zoo served and saved, against collie_tpu's.

Models and params as in ``tests/test_torch_zoo.py``.  ``recommend`` ids
(with and without ``filter_seen``; the zoo takes the blockwise path, MF the
dense one) are equal, scores and ``evaluate_in_batches`` metrics within
rtol 1e-5 / atol 1e-6.  npz files cross both ways with equal params and
scores, except callable final layers, which JAX does not serialize either.
"""
from unittest import mock

import numpy as np
import pytest

import collie_tpu.models as jax_models
import collie_tpu_torch
from collie_tpu.evaluate import evaluate_in_batches as jax_evaluate
from collie_tpu.ops import auc as jax_auc
from collie_tpu.ops import mapk as jax_mapk
from collie_tpu.ops import mrr as jax_mrr
from collie_tpu.retrieval import recommend as jax_recommend
from collie_tpu_torch import auc, evaluate_in_batches, mapk, mrr, recommend

from tests.test_torch_zoo import DATA, MAIN, VARIANTS, _ids, build_pair, data  # noqa: F401

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
NO_ROUNDTRIP = {'neucf_custom', 'deep_fm_custom'}


@pytest.mark.parametrize('variant', MAIN + ['mlp_mf_y_range', 'neucf_sigmoid'])
def test_recommend_and_evaluate_match_jax(variant, data):
    jax_model, model = build_pair(variant, data)
    (_, jax_test), (_, test) = data[4]
    users = np.arange(0, DATA['num_users'], 3)
    for filter_seen in (True, False):
        jax_ids, jax_scores = jax_recommend(jax_model, users, k=7, filter_seen=filter_seen,
                                            item_tile=32)
        ids, scores = recommend(model, users, k=7, filter_seen=filter_seen, item_tile=32)
        np.testing.assert_array_equal(ids, np.asarray(jax_ids))
        np.testing.assert_allclose(scores, np.asarray(jax_scores), **SCORE_TOL)
    ref = jax_evaluate([jax_mapk, jax_mrr, jax_auc], jax_test, jax_model, k=5, verbose=False)
    got = evaluate_in_batches([mapk, mrr, auc], test, model, k=5, verbose=False)
    np.testing.assert_allclose(got, ref, **SCORE_TOL)


@pytest.mark.parametrize('variant', sorted(set(VARIANTS) - NO_ROUNDTRIP))
def test_npz_crosses_both_ways(variant, data, tmp_path):
    jax_model, model = build_pair(variant, data)
    name = VARIANTS[variant][0]
    users, items, _ = _ids(np.random.default_rng(3))

    model.save_model(tmp_path / 'port.npz')
    jax_cls = getattr(jax_models, name)
    # the load replaces every param from the file: skip the random init
    with mock.patch.object(jax_cls, '_setup_model', lambda self, **_: None):
        from_port = jax_cls(load_model_path=tmp_path / 'port.npz')
    np.testing.assert_allclose(from_port(users, items), model(users, items), **SCORE_TOL)

    jax_model.save_model(tmp_path / 'jax.npz')
    from_jax = getattr(collie_tpu_torch, name)(load_model_path=tmp_path / 'jax.npz',
                                               map_location='cpu')
    np.testing.assert_allclose(from_jax(users, items), jax_model(users, items), **SCORE_TOL)
    for key, value in jax_model.params.items():
        np.testing.assert_array_equal(from_jax.params[key].numpy(), np.asarray(value))
    assert from_jax.hparams == from_port.hparams | {'load_model_path': str(tmp_path / 'jax.npz')}
