"""``HybridModel`` and ``HybridPretrainedModel`` of the port against collie_tpu's.

Pairs are built as in ``tests/test_torch_multi_stage.py`` (numpy params
carried across with ``params_from_jax``; the HybridPretrained pair copies
the same MF donor in each package).  Variants: item and user metadata
with towers, item metadata alone without a tower, user metadata alone.

Tolerances:

* ``score`` / ``pairwise_scores`` and the catalog hooks in every stage,
  in eval and in training on JAX's dropout masks (the user tower's, the
  item tower's, the combined layers'; in Hybrid's MF stage the two
  embedding masks): rtol 1e-5 / atol 1e-6;
* one step's loss and grads against ``jax.grad`` of JAX's dense
  ``calculate_loss``: rtol 1e-4 / atol 1e-6;
* directory saves cross both ways with equal params, metadata and final
  stage; scores of the loaded models within rtol 1e-5 / atol 1e-6.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

import collie_tpu.models as jax_models
import collie_tpu_torch
from collie_tpu.models.base import BasePipeline as JaxBasePipeline

from tests.test_torch_multi_stage import (DATA, SCORE_TOL, STAGES, assert_eval_scores_match,
                                          assert_step_matches, assert_training_scores_match,
                                          build_donors, build_pair, data, ids,  # noqa: F401
                                          set_stage)

HYBRID_CASES = [(variant, stage) for variant in ('both', 'item_only', 'user_only')
                for stage in STAGES['HybridModel']]


@pytest.mark.parametrize('variant,stage', HYBRID_CASES)
def test_hybrid_eval_scores_match_jax(variant, stage, data):
    jax_model, model = build_pair('HybridModel', data, variant)
    set_stage(stage, jax_model, model)
    assert_eval_scores_match(jax_model, model)


@pytest.mark.parametrize('variant,stage', HYBRID_CASES)
def test_hybrid_training_scores_match_jax_on_its_masks(variant, stage, data, monkeypatch):
    jax_model, model = build_pair('HybridModel', data, variant, dropout_p=0.3)
    set_stage(stage, jax_model, model)
    assert_training_scores_match(jax_model, model, monkeypatch)


@pytest.mark.parametrize('stage', STAGES['HybridModel'])
def test_hybrid_step_matches_jax(stage, data, monkeypatch):
    jax_model, model = build_pair('HybridModel', data)
    set_stage(stage, jax_model, model)
    assert_step_matches(jax_model, model, monkeypatch)


@pytest.mark.parametrize('variant', ['both', 'item_only', 'user_only'])
def test_hybrid_pretrained_eval_scores_match_jax(variant, data):
    jax_model, model = build_pair('HybridPretrainedModel', data, variant)
    assert_eval_scores_match(jax_model, model)


@pytest.mark.parametrize('variant', ['both', 'item_only'])
def test_hybrid_pretrained_training_scores_match_jax_on_its_masks(variant, data, monkeypatch):
    jax_model, model = build_pair('HybridPretrainedModel', data, variant, dropout_p=0.3)
    assert_training_scores_match(jax_model, model, monkeypatch)


@pytest.mark.parametrize('frozen', [True, False])
def test_hybrid_pretrained_step_matches_jax(frozen, data, monkeypatch):
    """Frozen embedding tables get no gradient (zero in JAX, none here),
    and are left out of the one optimizer spec."""
    jax_model, model = build_pair('HybridPretrainedModel', data)
    if not frozen:
        jax_model.unfreeze_embeddings()
        model.unfreeze_embeddings()
    assert_step_matches(jax_model, model, monkeypatch)
    spec, = model.optimizer_specs()
    ref, = jax_model.optimizer_specs()
    assert (spec.name, spec.keys) == (ref.name, ref.keys)
    assert ('item_embeddings' in spec.keys) == (not frozen)


def test_hybrid_pretrained_copies_and_never_aliases_the_donor(data):
    jax_donor, donor = build_donors(data)
    before = {k: v.clone() for k, v in donor.params.items()}
    _, model = build_pair('HybridPretrainedModel', data, donors=(jax_donor, donor))
    for key in ('user_embeddings', 'item_embeddings', 'user_biases', 'item_biases'):
        assert torch.equal(model.params[key], before[key])
        assert (getattr(model, key).untyped_storage().data_ptr()
                != getattr(donor, key).untyped_storage().data_ptr())
        with torch.no_grad():
            getattr(model, key).add_(1.0)
        assert torch.equal(donor.params[key], before[key])
    assert list(model.children()) == []
    assert not any(p is q for p in model.parameters() for q in donor.parameters())


def test_hybrid_pretrained_records_the_donors_dims(data):
    jax_model, model = build_pair('HybridPretrainedModel', data)
    for key in ('user_num_embeddings', 'user_embeddings_dim', 'item_num_embeddings',
                'item_embeddings_dim'):
        assert model.hparams[key] == jax_model.hparams[key]
    assert (model.hparams['item_num_embeddings'], model.hparams['item_embeddings_dim']) == \
        (DATA['num_items'], 8)


@pytest.mark.parametrize('name', ['HybridModel', 'HybridPretrainedModel'])
def test_metadata_and_donor_stay_out_of_hparams(name, data):
    _, model = build_pair(name, data)
    for key in ('item_metadata', 'user_metadata', 'trained_model'):
        assert key not in model.hparams
    assert model.item_metadata.dtype == torch.float32
    np.testing.assert_array_equal(model.item_metadata.numpy(), data['item_metadata'])
    np.testing.assert_array_equal(model.user_metadata.numpy(), data['user_metadata'])


@pytest.mark.parametrize('name', ['HybridModel', 'HybridPretrainedModel'])
def test_metadata_with_nans_raises(name, data):
    train = data['torch'][0]
    kwargs = dict(item_metadata=np.full((DATA['num_items'], 3), np.nan, dtype=np.float32),
                  map_location='cpu')
    if name == 'HybridPretrainedModel':
        kwargs['trained_model'] = build_donors(data)[1]
    with pytest.raises(ValueError, match='may not contain nulls'):
        getattr(collie_tpu_torch, name)(train=train, **kwargs)


def test_construction_errors_match_jax(data):
    train, jax_train = data['torch'][0], data['jax'][0]
    cases = [('HybridModel', {}, 'Must provide item metadata'),
             ('HybridPretrainedModel', dict(item_metadata=data['item_metadata']),
              'trained_model')]
    for name, kwargs, match in cases:
        with pytest.raises(ValueError, match=match) as err:
            getattr(collie_tpu_torch, name)(train=train, map_location='cpu', **kwargs)
        with pytest.raises(ValueError) as ref:
            getattr(jax_models, name)(train=jax_train, **kwargs)
        assert str(err.value) == str(ref.value)


@pytest.mark.parametrize('name', ['HybridModel', 'HybridPretrainedModel'])
def test_hybrids_need_a_card_or_map_location(name, data, monkeypatch):
    kwargs = dict(item_metadata=data['item_metadata'], seed=0)
    if name == 'HybridPretrainedModel':
        kwargs['trained_model'] = build_donors(data)[1]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="map_location='cpu'"):
        getattr(collie_tpu_torch, name)(train=data['torch'][0], **kwargs)


def test_load_from_hybrid_model(data):
    _, model_a = build_pair('HybridPretrainedModel', data)
    _, model_b = build_pair('HybridPretrainedModel', data, seed=99)
    users, items, _ = ids(np.random.default_rng(4))
    assert not np.allclose(model_a(users, items), model_b(users, items))
    model_b.load_from_hybrid_model(model_a)
    np.testing.assert_array_equal(model_a(users, items), model_b(users, items))
    assert model_b.hparams == model_a.hparams
    for key, value in model_a.params.items():
        assert torch.equal(model_b.params[key], value)
        assert getattr(model_b, key).untyped_storage().data_ptr() != \
            getattr(model_a, key).untyped_storage().data_ptr()


def test_hybrid_save_refuses_to_overwrite(data, tmp_path):
    _, model = build_pair('HybridModel', data, 'item_only')
    model.save_model(tmp_path / 'hybrid')
    with pytest.raises(ValueError, match='overwrite'):
        model.save_model(tmp_path / 'hybrid')
    model.save_model(tmp_path / 'hybrid', overwrite=True)
    assert sorted(os.listdir(tmp_path / 'hybrid')) == ['item_metadata.npy', 'model.npz']


SAVE_CASES = [('HybridModel', 'both'), ('HybridModel', 'user_only'),
              ('HybridPretrainedModel', 'both')]


@pytest.mark.parametrize('name,variant', SAVE_CASES)
def test_directory_saves_cross_both_ways(name, variant, data, tmp_path):
    """A directory of either package loads in the other: equal params,
    metadata, hparams and scores, in the final stage, with no donor."""
    jax_model, model = build_pair(name, data, variant)
    users, items, _ = ids(np.random.default_rng(3))
    model.save_model(tmp_path / 'port')
    with mock.patch.object(JaxBasePipeline, '_setup_model', lambda self, **_: None):
        from_port = getattr(jax_models, name)(load_model_path=tmp_path / 'port')
    jax_model.save_model(tmp_path / 'jax')
    from_jax = getattr(collie_tpu_torch, name)(load_model_path=tmp_path / 'jax',
                                               map_location='cpu')
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax'))
    final = STAGES[name][-1]
    assert from_port.current_stage == from_jax.current_stage == final
    for key, value in jax_model.params.items():
        np.testing.assert_array_equal(from_jax.params[key].numpy(), np.asarray(value))
        np.testing.assert_array_equal(np.asarray(from_port.params[key]),
                                      model.params[key].numpy())
    for key in ('item_metadata', 'user_metadata'):
        ref = getattr(jax_model, key)
        got = getattr(from_jax, key)
        assert (got is None) == (ref is None) == (getattr(from_port, key) is None)
        if ref is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            np.testing.assert_array_equal(np.asarray(getattr(from_port, key)),
                                          getattr(model, key).numpy())
    np.testing.assert_allclose(from_jax(users, items), from_port(users, items), **SCORE_TOL)
    set_stage(final, jax_model)
    np.testing.assert_allclose(from_jax(users, items), jax_model(users, items), **SCORE_TOL)
    assert from_jax.hparams == from_port.hparams | {
        'load_model_path': str(tmp_path / 'jax' / 'model.npz')}


def test_missing_metadata_file_warns_on_load(data, tmp_path):
    _, model = build_pair('HybridModel', data)
    model.save_model(tmp_path / 'hybrid')
    os.remove(tmp_path / 'hybrid' / 'item_metadata.npy')
    with pytest.warns(UserWarning, match='item_metadata.npy'):
        loaded = collie_tpu_torch.HybridModel(load_model_path=tmp_path / 'hybrid',
                                              map_location='cpu')
    assert loaded.item_metadata is None and loaded.user_metadata is not None
    with_meta = collie_tpu_torch.HybridModel(load_model_path=tmp_path / 'hybrid',
                                             map_location='cpu',
                                             item_metadata=data['item_metadata'])
    np.testing.assert_array_equal(with_meta.item_metadata.numpy(), data['item_metadata'])
    users, items, _ = ids(np.random.default_rng(5))
    set_stage('all', model)
    np.testing.assert_allclose(with_meta(users, items), model(users, items), **SCORE_TOL)
