"""The port's single-stage model zoo against collie_tpu's, model by model.

Each variant is built in both packages on the same small data, with the
JAX model's params drawn with numpy from a seed and carried to the port
with ``params_from_jax``.  Then, as ``tests/test_model_zoo.py`` parametrises
the JAX zoo:

* ``score``, ``pairwise_scores`` and the catalog hooks equal JAX's in eval
  mode, and in training mode on JAX's dropout masks, recorded from JAX's
  (jitted) program and replayed in order through the port's
  ``dropout_mask`` (rtol 1e-5 / atol 1e-6);
* the model-specific contracts: NeuMF's final layers, CML's distances,
  Nonlinear-MF's post-tower similarity embeddings, the chunked default
  catalog hooks, and construction needing a card or ``map_location``.

``recommend``, ``evaluate_in_batches`` and npz files are in
``tests/test_torch_zoo_serving.py``; one batch's loss and grads in
``tests/test_torch_zoo_step.py``; one training epoch of each model against
JAX's in ``tests/test_torch_zoo_training.py``.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collie_tpu.models as jax_models
import collie_tpu_torch
from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu_torch import params_from_jax, stratified_split
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.models.base import BasePipeline

from tests.test_torch_dropout import MaskTape

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
DATA = dict(num_users=40, num_items=120, num_interactions=1500, seed=1)

_NLMF = dict(user_embedding_dim=6, item_embedding_dim=5, user_dense_layers_dims=[6, 4],
             item_dense_layers_dims=[5, 4], dense_dropout_p=0.2, embedding_dropout_p=0.1)
# variant -> (class name in both packages, kwargs); final_layer 'tanh' stands
# for a callable (jnp.tanh in JAX, torch.tanh in the port)
VARIANTS = {
    'mf_dropout': ('MatrixFactorizationModel', dict(embedding_dim=6, dropout_p=0.2)),
    'mf_dropout_y_range': ('MatrixFactorizationModel',
                           dict(embedding_dim=6, dropout_p=0.3, y_range=(0, 4))),
    'mlp_mf': ('MLPMatrixFactorizationModel', dict(embedding_dim=6, num_layers=2,
                                                   dropout_p=0.2)),
    'mlp_mf_y_range': ('MLPMatrixFactorizationModel',
                       dict(embedding_dim=6, num_layers=3, dropout_p=0.1, y_range=(0, 4))),
    'nonlinear_mf': ('NonlinearMatrixFactorizationModel', _NLMF),
    'nonlinear_mf_y_range': ('NonlinearMatrixFactorizationModel',
                             dict(_NLMF, dense_dropout_p=0.0, y_range=(0, 4))),
    'neucf': ('NeuralCollaborativeFiltering', dict(embedding_dim=4, num_layers=2,
                                                   dropout_p=0.2)),
    'deep_fm': ('DeepFM', dict(embedding_dim=6, num_layers=2, dropout_p=0.2)),
    'cml': ('CollaborativeMetricLearningModel', dict(embedding_dim=6)),
}
for _name in ('neucf', 'deep_fm'):
    for _layer in ('sigmoid', 'relu', 'leaky_relu', 'tanh'):
        _cls, _kw = VARIANTS[_name]
        VARIANTS[f'{_name}_{"custom" if _layer == "tanh" else _layer}'] = (
            _cls, dict(_kw, final_layer=_layer))
MAIN = ['mf_dropout', 'mlp_mf', 'nonlinear_mf', 'neucf', 'deep_fm', 'cml']
# every dropout path: MF, the MLP tower, both NLMF dropouts, NeuMF, DeepFM,
# with and without y_range (final layers act after the last draw)
WITH_DROPOUT = ['mf_dropout', 'mf_dropout_y_range', 'mlp_mf', 'mlp_mf_y_range',
                'nonlinear_mf', 'nonlinear_mf_y_range', 'neucf', 'deep_fm']


@pytest.fixture(scope='module')
def data():
    """``{K: ((jax_train, jax_test), (train, test))}`` for K = 4 and 1."""
    out = {}
    for K in (4, 1):
        kw = dict(DATA, num_negative_samples=K)
        jax_sets = jax_split(jax_generate(**kw), test_p=0.2, seed=1, force_split=True)
        sets = stratified_split(generate_implicit_interactions(**kw), test_p=0.2, seed=1,
                                force_split=True)
        out[K] = (jax_sets, sets)
    return out


def _kwargs(kwargs, package):
    kwargs = dict(kwargs)
    if kwargs.get('final_layer') == 'tanh':
        kwargs['final_layer'] = jnp.tanh if package == 'jax' else torch.tanh
    return kwargs


def build_pair(variant, data, K=4, loss='adaptive', seed=0, **overrides):
    """``(jax_model, model)``: the JAX model with params drawn with numpy
    at the names and shapes of its ``_build_params`` (found by
    ``jax.eval_shape``, which compiles nothing), and the port's model
    carrying them."""
    name, kwargs = VARIANTS[variant]
    kwargs = dict(kwargs, **overrides)
    (jax_train, _), (train, _) = data[K]
    common = dict(lr=1e-2, loss=loss, seed=0)
    rng = np.random.default_rng(seed)

    def numpy_params(self, **_):
        shapes = jax.eval_shape(self._build_params, jax.random.PRNGKey(0))
        self.params = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.5)
                       for k, v in sorted(shapes.items())}

    jax_cls = getattr(jax_models, name)
    with mock.patch.object(jax_cls, '_setup_model', numpy_params):
        jax_model = jax_cls(train=jax_train, **common, **_kwargs(kwargs, 'jax'))
    model = getattr(collie_tpu_torch, name)(train=train, map_location='cpu', **common,
                                            **_kwargs(kwargs, 'torch'))
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    assert {k: tuple(v.shape) for k, v in model.params.items()} == \
        {k: tuple(v.shape) for k, v in jax_model.params.items()}
    return jax_model, model


def _generator(seed=0):
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


def _ids(rng, B=16, R=4):
    users = rng.integers(0, DATA['num_users'], B)
    pos = rng.integers(0, DATA['num_items'], B)
    cand = rng.integers(0, DATA['num_items'], (R, B))
    return users, pos, cand


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.int32))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_eval_scores_match_jax(variant, data):
    jax_model, model = build_pair(variant, data)
    users, pos, cand = _ids(np.random.default_rng(0))

    @jax.jit
    def jax_scores(p, u, i, c):
        return (jax_model.score(p, u, i), jax_model.pairwise_scores(p, u, c),
                jax_model.score_item_block(p, u[:5], c[0]), jax_model.score_all_items(p, u[:4]))

    refs = jax_scores(jax_model.params, _j(users), _j(pos), _j(cand))
    p, u = model.params, _t(users)
    with torch.no_grad():
        outs = (model.score(p, u, _t(pos)), model.pairwise_scores(p, u, _t(cand)),
                model.score_item_block(p, u[:5], _t(cand[0])), model.score_all_items(p, u[:4]))
    for name, out, ref in zip(('score', 'pairwise_scores', 'score_item_block',
                               'score_all_items'), outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SCORE_TOL, err_msg=name)
    np.testing.assert_allclose(model(users, pos), np.asarray(refs[0]), **SCORE_TOL)


@pytest.mark.parametrize('variant', WITH_DROPOUT)
def test_training_scores_match_jax_on_injected_masks(variant, data, monkeypatch):
    jax_model, model = build_pair(variant, data)
    tape = MaskTape(monkeypatch)
    users, pos, cand = _ids(np.random.default_rng(1))

    @jax.jit
    def jax_scores(p, u, i, c, key):
        return (jax_model.score(p, u, i, training=True, rng=key),
                jax_model.pairwise_scores(p, u, c, training=True, rng=key))

    ref_score, ref_pair = jax_scores(jax_model.params, _j(users), _j(pos), _j(cand),
                                     jax.random.PRNGKey(5))
    drawn = len(tape.masks)
    assert any(not mask.all() for mask, _ in tape.masks), 'no JAX mask dropped anything'
    with torch.no_grad():
        score = model.score(model.params, _t(users), _t(pos), training=True,
                            generator=_generator())
        pair = model.pairwise_scores(model.params, _t(users), _t(cand), training=True,
                                     generator=_generator())
    assert not tape.masks, f'{len(tape.masks)} of {drawn} JAX masks were not drawn'
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), **SCORE_TOL)
    np.testing.assert_allclose(pair.numpy(), np.asarray(ref_pair), **SCORE_TOL)


def test_neucf_invalid_final_layer_raises(data):
    _, model = build_pair('neucf', data, final_layer='nonsense')
    with pytest.raises(ValueError, match='not valid final layer'):
        model(np.array([0]), np.array([0]))


def test_callable_final_layer_is_an_attribute(data):
    _, model = build_pair('deep_fm_custom', data)
    assert model.hparams['final_layer'] is None and model.final_layer is torch.tanh
    assert np.all(np.abs(model(np.arange(5), np.arange(5))) <= 1)


def test_cml_scores_are_distances(data):
    _, model = build_pair('cml', data)
    users, items = np.arange(10), np.arange(10, 20)
    u = model.params['user_embeddings'][users].numpy()
    i = model.params['item_embeddings'][items].numpy()
    np.testing.assert_allclose(model(users, items),
                               np.linalg.norm(u - i + 1e-6, axis=1), **SCORE_TOL)
    assert 'y_range' in model.hparams


def test_nonlinear_mf_similarity_uses_post_tower_embeddings(data):
    jax_model, model = build_pair('nonlinear_mf', data)
    emb = model._get_item_embeddings()
    assert tuple(emb.shape) == (DATA['num_items'], 4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jax_model._get_item_embeddings()),
                               **SCORE_TOL)
    sims, ref = model.item_item_similarity(3), jax_model.item_item_similarity(3)
    np.testing.assert_allclose(sims.sort_index().values, ref.sort_index().values, **SCORE_TOL)
    np.testing.assert_allclose(model.user_user_similarity(2).sort_index().values,
                               jax_model.user_user_similarity(2).sort_index().values,
                               **SCORE_TOL)


def test_nonlinear_mf_post_tower_embeddings_never_go_stale(data):
    _, model = build_pair('nonlinear_mf', data)
    first = model._get_item_embeddings()
    assert model._get_item_embeddings() is first              # cached
    with torch.no_grad():
        model.item_dense_0_bias.add_(1.0)                      # in-place edit
    edited = model._get_item_embeddings()
    assert not torch.equal(edited, first)
    model.load_params({k: v + 0.5 for k, v in model.params.items()})   # a load, as fit ends
    assert not torch.equal(model._get_item_embeddings(), edited)
    assert not torch.equal(model._get_user_embeddings(), first[:0])


@pytest.mark.parametrize('variant', ['mlp_mf', 'neucf'])
def test_default_catalog_hooks_chunk_items(variant, data):
    """The default hooks score at most ``SCORE_BLOCK_PAIRS`` pairs a call,
    every chunk at one shape: an item's score does not depend on its chunk
    (bit for bit), and the chunked block equals the unchunked one to
    float32 rounding (a BLAS may round a row differently in a taller
    matrix)."""
    _, model = build_pair(variant, data)
    assert type(model).score_item_block is BasePipeline.score_item_block
    users = torch.arange(9)
    items = torch.arange(DATA['num_items'])
    calls = []
    score = model.score
    model.score = lambda p, u, i, **kw: calls.append(len(u)) or score(p, u, i, **kw)
    with torch.no_grad():
        whole = model.score_all_items(model.params, users)
        model.SCORE_BLOCK_PAIRS = 9 * 7          # 7-item chunks, the last one padded
        chunked = model.score_all_items(model.params, users)
        shifted = model.score_item_block(model.params, users, items[7:30])
    assert calls == [9 * DATA['num_items']] + [9 * 7] * -(-DATA['num_items'] // 7) + [9 * 7] * 4
    assert torch.equal(shifted, chunked[:, 7:30])
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('name', ['MLPMatrixFactorizationModel',
                                  'NonlinearMatrixFactorizationModel',
                                  'NeuralCollaborativeFiltering', 'DeepFM',
                                  'CollaborativeMetricLearningModel'])
def test_zoo_models_need_a_card_or_map_location(name, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    (_, _), (train, _) = data[4]
    with pytest.raises(RuntimeError, match="map_location='cpu'"):
        getattr(collie_tpu_torch, name)(train=train, seed=0)
