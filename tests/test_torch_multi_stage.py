"""The stage machinery and ``ColdStartModel`` of the port against collie_tpu's.

Models are built in both packages on the same small data (40 users x 30
items, D = 8), the JAX model's params drawn with numpy at the names and
shapes of its ``_build_params`` (``jax.eval_shape``, which compiles
nothing) and carried to the port with ``params_from_jax``.  The helpers
here serve ``tests/test_torch_hybrid.py`` and
``tests/test_torch_multi_stage_training.py`` too.

Tolerances:

* ``score`` / ``pairwise_scores`` (and the catalog hooks) in every stage,
  in eval and in training on JAX's dropout masks (recorded from JAX's
  program and replayed through the port's ``dropout_mask``): rtol 1e-5 /
  atol 1e-6;
* one step's loss and grads against ``jax.grad`` of JAX's dense
  ``calculate_loss``: rtol 1e-4 / atol 1e-6;
* ColdStart's ``item_buckets -> no_buckets`` copy: exact, as JAX's;
* stage lists, optimizer specs, validation messages, hparams and npz
  files: equal.
"""
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collie_tpu.models as jax_models
import collie_tpu_torch
from collie_tpu.data import InteractionsDataLoader as JaxLoader
from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu.models.base import BasePipeline as JaxBasePipeline
from collie_tpu_torch import InteractionsDataLoader, params_from_jax, stratified_split
from collie_tpu_torch.data.synthetic import generate_implicit_interactions

from tests.test_torch_dropout import MaskTape

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DATA = dict(num_users=40, num_items=30, num_interactions=1000, seed=1, num_negative_samples=4)
D = 8
BATCH = 64
COMMON = dict(lr=1e-2, loss='adaptive', seed=0)
STAGES = {'ColdStartModel': ['item_buckets', 'no_buckets'],
          'HybridModel': ['matrix_factorization', 'metadata_only', 'all'],
          'HybridPretrainedModel': [None]}


@pytest.fixture(scope='module')
def data():
    """``((jax_train, jax_test), (train, test))`` plus the metadata and buckets."""
    jax_sets = jax_split(jax_generate(**DATA), test_p=0.2, seed=1, force_split=True)
    sets = stratified_split(generate_implicit_interactions(**DATA), test_p=0.2, seed=1,
                            force_split=True)
    n_users, n_items = DATA['num_users'], DATA['num_items']
    buckets = np.random.default_rng(9).integers(0, 5, n_items)
    buckets[0] = 0
    return {'jax': jax_sets, 'torch': sets,
            'item_metadata': np.eye(6, dtype=np.float32)[
                np.random.default_rng(7).integers(0, 6, n_items)],
            'user_metadata': np.random.default_rng(8).random((n_users, 4)).astype(np.float32),
            'item_buckets': buckets}


def _numpy_setup(rng):
    """A ``_setup_model`` for JAX's ``BasePipeline`` that draws every param
    with numpy at the shapes of ``_build_params``."""
    def setup(self, **_):
        shapes = jax.eval_shape(self._build_params, jax.random.PRNGKey(0))
        self.params = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.5)
                       for k, v in sorted(shapes.items())}
    return setup


def _train_sets(data, loader):
    (jax_train, _), (train, _) = data['jax'], data['torch']
    if loader:
        return (JaxLoader(interactions=jax_train, batch_size=BATCH, shuffle=True),
                InteractionsDataLoader(interactions=train, batch_size=BATCH, shuffle=True))
    return jax_train, train


def build_donors(data, seed=1, loader=False):
    """``(jax_mf, mf)``: the same MF in both packages, numpy params."""
    jax_train, train = _train_sets(data, loader)
    with mock.patch.object(JaxBasePipeline, '_setup_model', _numpy_setup(
            np.random.default_rng(seed))):
        jax_mf = jax_models.MatrixFactorizationModel(train=jax_train, embedding_dim=D, **COMMON)
    mf = collie_tpu_torch.MatrixFactorizationModel(train=train, embedding_dim=D,
                                                   map_location='cpu', **COMMON)
    mf.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_mf.params.items()}, 'cpu'))
    return jax_mf, mf


def model_kwargs(name, data, variant='both'):
    """Constructor kwargs (beyond the common ones) of each model variant."""
    if name == 'ColdStartModel':
        return dict(item_buckets=data['item_buckets'], embedding_dim=D)
    meta = {'both': dict(item_metadata=data['item_metadata'],
                         user_metadata=data['user_metadata'],
                         item_metadata_layers_dims=[D], user_metadata_layers_dims=[D]),
            'item_only': dict(item_metadata=data['item_metadata']),
            'user_only': dict(user_metadata=data['user_metadata'],
                              user_metadata_layers_dims=[D])}[variant]
    kwargs = dict(meta, combined_layers_dims=[16])
    if name == 'HybridModel':
        kwargs['embedding_dim'] = D
    return kwargs


def build_pair(name, data, variant='both', seed=0, loader=False, donors=None, **overrides):
    """``(jax_model, model)`` of ``name`` on the same data and params; the
    HybridPretrained pair copies ``donors`` (``build_donors`` when None)."""
    jax_train, train = _train_sets(data, loader)
    kwargs = dict(model_kwargs(name, data, variant), **COMMON)
    kwargs.update(overrides)
    jax_kwargs, torch_kwargs = dict(kwargs), dict(kwargs)
    if name == 'HybridPretrainedModel':
        jax_donor, donor = donors or build_donors(data)
        jax_kwargs['trained_model'], torch_kwargs['trained_model'] = jax_donor, donor
    with mock.patch.object(JaxBasePipeline, '_setup_model', _numpy_setup(
            np.random.default_rng(seed))):
        jax_model = getattr(jax_models, name)(train=jax_train, **jax_kwargs)
    model = getattr(collie_tpu_torch, name)(train=train, map_location='cpu', **torch_kwargs)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    assert {k: tuple(v.shape) for k, v in model.params.items()} == \
        {k: tuple(v.shape) for k, v in jax_model.params.items()}
    assert model.current_stage == jax_model.current_stage
    return jax_model, model


def set_stage(stage, *models):
    """Put each model in ``stage`` the way a user does: ``advance_stage``."""
    for m in models:
        while m.current_stage != stage:
            m.advance_stage()


def generator(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def ids(rng, B=16, R=4):
    users = rng.integers(0, DATA['num_users'], B)
    pos = rng.integers(0, DATA['num_items'], B)
    cand = rng.integers(0, DATA['num_items'], (R, B))
    return users, pos, cand


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.int32))


def assert_eval_scores_match(jax_model, model, seed=0):
    """``score``, ``pairwise_scores``, ``score_item_block``,
    ``score_all_items`` and ``forward`` equal JAX's in eval mode."""
    users, pos, cand = ids(np.random.default_rng(seed))
    p = jax_model.params
    refs = (jax_model.score(p, _j(users), _j(pos)),
            jax_model.pairwise_scores(p, _j(users), _j(cand)),
            jax_model.score_item_block(p, _j(users[:5]), _j(cand[0])),
            jax_model.score_all_items(p, _j(users[:4])))
    tp, u = model.params, _t(users)
    with torch.no_grad():
        outs = (model.score(tp, u, _t(pos)), model.pairwise_scores(tp, u, _t(cand)),
                model.score_item_block(tp, u[:5], _t(cand[0])),
                model.score_all_items(tp, u[:4]))
    for label, out, ref in zip(('score', 'pairwise_scores', 'score_item_block',
                                'score_all_items'), outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SCORE_TOL, err_msg=label)
    np.testing.assert_allclose(model(users, pos), np.asarray(refs[0]), **SCORE_TOL)


def assert_training_scores_match(jax_model, model, monkeypatch, seed=1):
    """``score`` and ``pairwise_scores`` in training mode equal JAX's on
    JAX's dropout masks, each mask drawn in JAX's order and shape."""
    tape = MaskTape(monkeypatch)
    users, pos, cand = ids(np.random.default_rng(seed))
    key = jax.random.PRNGKey(5)
    ref_score = jax_model.score(jax_model.params, _j(users), _j(pos), training=True, rng=key)
    ref_pair = jax_model.pairwise_scores(jax_model.params, _j(users), _j(cand), training=True,
                                         rng=key)
    drawn = len(tape.masks)
    assert drawn and any(not mask.all() for mask, _ in tape.masks), 'no JAX mask dropped'
    with torch.no_grad():
        score = model.score(model.params, _t(users), _t(pos), training=True,
                            generator=generator())
        pair = model.pairwise_scores(model.params, _t(users), _t(cand), training=True,
                                     generator=generator())
    assert not tape.masks, f'{len(tape.masks)} of {drawn} JAX masks were not drawn'
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), **SCORE_TOL)
    np.testing.assert_allclose(pair.numpy(), np.asarray(ref_pair), **SCORE_TOL)


def step_batch(rng, K=DATA['num_negative_samples'], B=16):
    users, pos, _ = ids(rng, B)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    return {'users': users.astype(np.int32), 'pos_items': pos.astype(np.int32),
            'neg_items': rng.integers(0, DATA['num_items'], (B, K)).astype(np.int32),
            'mask': mask}


def assert_step_matches(jax_model, model, monkeypatch, seed=2):
    """One batch's loss and every param's gradient equal ``jax.grad`` of
    JAX's dense ``calculate_loss`` (on JAX's masks when there is dropout)."""
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    tape = MaskTape(monkeypatch)
    batch = step_batch(np.random.default_rng(seed))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_model.calculate_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                           rng=jax.random.PRNGKey(9), training=True))(
        jax_model.params)
    leaves = {k: v.clone().requires_grad_() for k, v in model.params.items()}
    loss = model.calculate_loss(leaves, {k: torch.from_numpy(v) for k, v in batch.items()},
                                generator=generator(), training=True)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert not tape.masks
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **GRAD_TOL)
    for (name, value), grad in zip(leaves.items(), grads):
        grad = torch.zeros_like(value) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grads[name]), **GRAD_TOL,
                                   err_msg=f'grad of {name}')


# ------------------------------------------------------------ stage machinery

SPEC_VARIANTS = {
    'cold_start': ('ColdStartModel', {}),
    'hybrid': ('HybridModel', {}),
    'hybrid_bias_infer': ('HybridModel', dict(bias_optimizer='infer', bias_lr='infer')),
    'hybrid_one_mf_optimizer': ('HybridModel', dict(bias_optimizer=None)),
    'hybrid_item_only': ('HybridModel', dict(variant='item_only')),
}


@pytest.mark.parametrize('variant', sorted(SPEC_VARIANTS))
def test_stages_and_optimizer_specs_match_jax(variant, data):
    """``stage_list`` is the ordered unique stages of the configs, a model
    starts in the first, and ``optimizer_specs`` give JAX's names, keys,
    stages, optimizers and learning rates."""
    name, overrides = SPEC_VARIANTS[variant]
    jax_model, model = build_pair(name, data, **overrides)
    assert model.hparams['stage_list'] == jax_model.hparams['stage_list'] == STAGES[name]
    assert model.current_stage == STAGES[name][0]
    for spec, ref in zip(model.optimizer_specs(), jax_model.optimizer_specs(), strict=True):
        assert (spec.name, spec.keys, spec.stage) == (ref.name, ref.keys, ref.stage)
    configs = [(c['optimizer'], c['lr']) for c in jax_model.hparams['optimizer_config_list']]
    assert [(s.transform.optimizer, s.transform.lr) for s in model.optimizer_specs()] == \
        [configs[int(s.name.split(':')[1])] for s in model.optimizer_specs()]


def test_advance_and_set_stage_raise_as_jax(data):
    jax_model, model = build_pair('ColdStartModel', data)
    with pytest.raises(ValueError, match='is not a valid stage') as err:
        model.set_stage('nonsense')
    with pytest.raises(ValueError) as ref:
        jax_model.set_stage('nonsense')
    assert str(err.value) == str(ref.value)
    set_stage('no_buckets', jax_model, model)
    with pytest.raises(ValueError, match='final stage') as err:
        model.advance_stage()
    with pytest.raises(ValueError) as ref:
        jax_model.advance_stage()
    assert str(err.value) == str(ref.value)
    assert model.current_stage == 'no_buckets'


def test_multi_stage_pipeline_needs_its_configs(data):
    train = data['torch'][0]
    with pytest.raises(ValueError, match='optimizer_config_list'):
        collie_tpu_torch.MultiStagePipeline(train=train, map_location='cpu')


def test_single_stage_models_have_no_stage(data):
    _, mf = build_donors(data)
    assert mf.current_stage is None and 'stage_list' not in mf.hparams


# ---------------------------------------------------------------- ColdStart

def test_cold_start_bucket_validation_matrix(data):
    """``tests/test_multi_stage.py``'s bad-bucket matrix with JAX's
    exception types and messages: 2-d, 1-indexed, too short, too long."""
    train = data['torch'][0]
    jax_train = data['jax'][0]
    n = train.num_items
    rng = np.random.default_rng(0)
    cases = [(AssertionError, '1-dimensional', rng.integers(0, 5, (n, 2))),
             (ValueError, 'start at 0', rng.integers(1, 5, n)),
             (ValueError, 'start at 0', np.ones(n, dtype=int)),
             (ValueError, 'Length of', [0, 1, 2]),
             (ValueError, 'Length of', np.zeros(n - 1, dtype=int)),
             (ValueError, 'Length of', np.zeros(n + 1, dtype=int))]
    for exc, match, buckets in cases:
        with pytest.raises(exc, match=match) as err:
            collie_tpu_torch.ColdStartModel(train=train, item_buckets=buckets,
                                            map_location='cpu')
        with pytest.raises(exc) as ref:
            jax_models.ColdStartModel(train=jax_train, item_buckets=buckets)
        assert str(err.value) == str(ref.value)


def test_cold_start_buckets_are_a_json_list_hparam(data):
    """Lists and arrays are accepted and stored as JAX stores them: a JSON
    list, with ``num_item_buckets`` beside it."""
    jax_model, model = build_pair('ColdStartModel', data)
    assert model.hparams['item_buckets'] == jax_model.hparams['item_buckets']
    assert isinstance(model.hparams['item_buckets'], list)
    assert json.loads(json.dumps(model.hparams['item_buckets'])) == model.hparams['item_buckets']
    assert model.hparams['num_item_buckets'] == jax_model.hparams['num_item_buckets'] == 5
    zeros = np.zeros(DATA['num_items'], dtype=int)
    m1 = collie_tpu_torch.ColdStartModel(train=data['torch'][0], item_buckets=zeros.tolist(),
                                         map_location='cpu', seed=0)
    m2 = collie_tpu_torch.ColdStartModel(train=data['torch'][0], item_buckets=zeros,
                                         map_location='cpu', seed=0)
    assert m1.hparams['item_buckets'] == m2.hparams['item_buckets']
    assert m1.hparams['num_item_buckets'] == 1


@pytest.mark.parametrize('stage', STAGES['ColdStartModel'])
def test_cold_start_eval_scores_match_jax(stage, data):
    jax_model, model = build_pair('ColdStartModel', data)
    set_stage(stage, jax_model, model)
    assert_eval_scores_match(jax_model, model)


@pytest.mark.parametrize('stage', STAGES['ColdStartModel'])
def test_cold_start_training_scores_match_jax_on_its_masks(stage, data, monkeypatch):
    jax_model, model = build_pair('ColdStartModel', data, dropout_p=0.3)
    set_stage(stage, jax_model, model)
    assert_training_scores_match(jax_model, model, monkeypatch)


@pytest.mark.parametrize('stage', STAGES['ColdStartModel'])
def test_cold_start_step_matches_jax(stage, data, monkeypatch):
    jax_model, model = build_pair('ColdStartModel', data)
    set_stage(stage, jax_model, model)
    assert_step_matches(jax_model, model, monkeypatch)


def test_cold_start_transition_copies_the_bucket_rows(data):
    """``advance_stage`` makes the per-item tables the gathered bucket rows,
    exactly and as JAX does, as new leaf parameters sharing no storage with
    the bucket tables; the other params keep their values."""
    jax_model, model = build_pair('ColdStartModel', data)
    before = {k: v.clone() for k, v in model.params.items()}
    old_item = model.item_embeddings
    set_stage('no_buckets', jax_model, model)
    buckets = torch.as_tensor(data['item_buckets'])
    assert torch.equal(model.params['item_embeddings'], before['item_bucket_embeddings'][buckets])
    assert torch.equal(model.params['item_biases'], before['item_bucket_biases'][buckets])
    for key in ('item_embeddings', 'item_biases'):
        np.testing.assert_array_equal(model.params[key].numpy(), np.asarray(jax_model.params[key]))
        param = getattr(model, key)
        assert isinstance(param, torch.nn.Parameter) and param.is_leaf and param.requires_grad
        bucket = getattr(model, key.replace('item_', 'item_bucket_'))
        assert param.untyped_storage().data_ptr() != bucket.untyped_storage().data_ptr()
    assert model.item_embeddings is not old_item
    with torch.no_grad():
        model.item_bucket_embeddings.add_(1.0)
    assert torch.equal(model.params['item_embeddings'], before['item_bucket_embeddings'][buckets])
    for key in ('user_embeddings', 'user_biases', 'item_bucket_biases'):
        assert torch.equal(model.params[key], before[key])


def test_cold_start_bucket_similarity_matches_jax(data):
    jax_model, model = build_pair('ColdStartModel', data)
    sims, ref = model.item_bucket_item_similarity(2), jax_model.item_bucket_item_similarity(2)
    assert len(sims) == DATA['num_items']
    np.testing.assert_allclose(sims.sort_index().values, ref.sort_index().values, **SCORE_TOL)


def test_cold_start_npz_crosses_both_ways(data, tmp_path):
    """A save of either package loads in the other in the final stage, with
    equal params, hparams and scores."""
    jax_model, model = build_pair('ColdStartModel', data)
    users, items, _ = ids(np.random.default_rng(3))
    model.save_model(tmp_path / 'port.npz')
    with mock.patch.object(JaxBasePipeline, '_setup_model', lambda self, **_: None):
        from_port = jax_models.ColdStartModel(load_model_path=tmp_path / 'port.npz')
    jax_model.save_model(tmp_path / 'jax.npz')
    from_jax = collie_tpu_torch.ColdStartModel(load_model_path=tmp_path / 'jax.npz',
                                               map_location='cpu')
    for loaded in (from_port, from_jax):
        assert loaded.current_stage == 'no_buckets'
    for key, value in jax_model.params.items():
        np.testing.assert_array_equal(from_jax.params[key].numpy(), np.asarray(value))
        np.testing.assert_array_equal(np.asarray(from_port.params[key]),
                                      model.params[key].numpy())
    np.testing.assert_allclose(from_jax(users, items), from_port(users, items), **SCORE_TOL)
    assert from_jax.hparams == from_port.hparams | {'load_model_path': str(tmp_path / 'jax.npz')}
    assert torch.equal(from_jax._item_buckets_device, torch.as_tensor(data['item_buckets']))


def test_cold_start_needs_a_card_or_map_location(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="map_location='cpu'"):
        collie_tpu_torch.ColdStartModel(train=data['torch'][0],
                                        item_buckets=data['item_buckets'], seed=0)


def test_cold_start_keeps_the_named_table_layout(data):
    """The generic epoch carries ColdStart's three pairs fused, as JAX's
    does; the model's params, what it saves and what an epoch returns, keep
    the named layout."""
    _, model = build_pair('ColdStartModel', data)
    assert model.supports_fused_tables() is True
    fused = model.fuse_params(model.params)
    assert set(fused) == {'user_fused', 'item_fused', 'item_bucket_fused'}
    assert set(model.params) == set(model.unfuse_params(fused))


def test_base_save_hooks_carry_extra_arrays(data, tmp_path):
    """``_extra_save_arrays`` adds arrays to the npz, ``_restore_extra_arrays``
    gets the open file and the constructor's keywords before the params
    load, and the JAX package reads such a file as it reads any other."""
    class WithExtra(collie_tpu_torch.MatrixFactorizationModel):
        def _extra_save_arrays(self):
            return {'extra:scale': np.arange(3, dtype=np.float32)}

        def _restore_extra_arrays(self, loaded, **kwargs):
            self.restored = (np.array(loaded['extra:scale']), kwargs.get('note'))

    _, mf = build_donors(data)
    model = WithExtra(train=data['torch'][0], embedding_dim=D, map_location='cpu', **COMMON)
    model.load_params(mf.params)
    model.save_model(tmp_path / 'extra.npz')
    loaded = WithExtra(load_model_path=tmp_path / 'extra.npz', map_location='cpu', note='n')
    np.testing.assert_array_equal(loaded.restored[0], np.arange(3, dtype=np.float32))
    assert loaded.restored[1] == 'n'
    with mock.patch.object(JaxBasePipeline, '_setup_model', lambda self, **_: None):
        from_port = jax_models.MatrixFactorizationModel(load_model_path=tmp_path / 'extra.npz')
    for key, value in model.params.items():
        np.testing.assert_array_equal(np.asarray(from_port.params[key]), value.numpy())
