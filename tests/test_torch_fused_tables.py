"""The fused table layout of the port's generic epoch.

MF, MLP-MF and Nonlinear-MF carry each (embeddings, biases) pair as one
``[*, D+1]`` table (the bias its last column), NeuMF each side's cf and
mlp tables as one ``[*, D + mlp_dim]`` table, and ColdStart its three
pairs in both stages (``COLLIE_TPU_FUSED_TABLES``, default on; JAX's
``collie_tpu/training/scan_engine.py:613-670``).  The values are the named
layout's, and on the CPU (one thread, so that every sum runs in one order)
bit for bit:

* one generic epoch from one state: params, optimizer states and loss;
* a 3-epoch fit (ColdStart 2 + 2 across ``advance_stage``): params and
  per-epoch losses;
* dropout masks are drawn after the fused gather, so with dropout too.

Also as in JAX's ``tests/test_fused_tables.py``: bfloat16-table models and
the models without a fused spec (a subclass of MF included) stay on the
named layout; the knob flipped between two fits takes effect; a fused fit
saves named keys that collie_tpu loads; and the slice as a whole: a
``fused=False`` MF fit at the port's defaults (sparse, bfloat16 selection,
fused tables) against JAX's default fit (``COLLIE_TPU_FUSED_EPOCH=0``) on
JAX's epoch draws, per-epoch losses within rtol 1e-4 at lr 0.03 (at lr 0.1
rounding-level flips of a hardest negative cascade, as
``chip_smoke.WHOLE_FIT_PAIR_LR`` records).
"""
import numpy as np
import pytest
import torch

import collie_tpu_torch
from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, params_from_jax
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.training import scan_engine
from collie_tpu_torch.training.optimizers import state_leaves

from tests.fixtures.loggers import EpochLossLogger

DATA = dict(num_users=60, num_items=90, num_interactions=2500, num_negative_samples=4, seed=1)
BATCH = 256
_NLMF = dict(user_embedding_dim=6, item_embedding_dim=5, user_dense_layers_dims=[6, 4],
             item_dense_layers_dims=[5, 4])
# name -> (class, kwargs)
FUSED = {
    'mf': ('MatrixFactorizationModel', dict(embedding_dim=6)),
    'mf_warp': ('MatrixFactorizationModel', dict(embedding_dim=6, loss='warp')),
    'mf_dropout': ('MatrixFactorizationModel', dict(embedding_dim=6, dropout_p=0.3)),
    'mlp_mf': ('MLPMatrixFactorizationModel', dict(embedding_dim=6, num_layers=2)),
    'mlp_mf_dropout': ('MLPMatrixFactorizationModel', dict(embedding_dim=6, num_layers=2,
                                                           dropout_p=0.3)),
    'nonlinear_mf': ('NonlinearMatrixFactorizationModel', _NLMF),
    'neucf': ('NeuralCollaborativeFiltering', dict(embedding_dim=4, num_layers=2)),
    'neucf_dropout': ('NeuralCollaborativeFiltering', dict(embedding_dim=4, num_layers=2,
                                                           dropout_p=0.3)),
    'cold_start': ('ColdStartModel', dict(embedding_dim=6)),
}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for knob in ('COLLIE_TPU_SPARSE_ADAPTIVE', 'COLLIE_TPU_BF16_SELECT',
                 'COLLIE_TPU_FUSED_TABLES', 'COLLIE_TPU_FUSED_EPOCH'):
        monkeypatch.delenv(knob, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def train():
    return generate_implicit_interactions(**DATA)


def _model(name, train, **overrides):
    cls, kwargs = FUSED.get(name, (name, {}))
    kwargs = dict({'lr': 0.05, 'loss': 'adaptive', 'seed': 3}, **kwargs, **overrides)
    if cls == 'ColdStartModel':
        kwargs['item_buckets'] = np.arange(train.num_items) % 7
        kwargs['item_buckets_stage_lr'] = kwargs['no_buckets_stage_lr'] = kwargs.pop('lr')
    loader = InteractionsDataLoader(interactions=train, batch_size=BATCH, shuffle=True, seed=0)
    return getattr(collie_tpu_torch, cls)(train=loader, map_location='cpu', **kwargs)


def _epoch(model, fused_tables, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_FUSED_TABLES', '1' if fused_tables else '0')
    specs = model.optimizer_specs()
    active = [spec.stage in (None, model.current_stage) for spec in specs]
    epoch_fn, data, _, _ = scan_engine.build_scan_epoch_fns(
        model, specs, active, model.train_loader, shuffle=True, fused=False)
    assert epoch_fn.fused_tables is fused_tables
    params = dict(model.params)
    states = tuple(spec.transform.init({k: params[k] for k in spec.keys}) for spec in specs)
    new_params, new_states, loss = epoch_fn(params, states, data, 0, 1)
    assert set(new_params) == set(params)
    untrained = set(params) - {k for s, on in zip(specs, active) if on for k in s.keys}
    assert all(new_params[k] is params[k] for k in untrained)
    return new_params, state_leaves(new_states), loss


def _assert_same(a, b, label):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), label
    else:
        assert a == b, label


@pytest.mark.parametrize('name', list(FUSED) + ['cold_start_no_buckets'])
def test_one_epoch_fused_equals_named_bitwise(name, train, monkeypatch):
    model = _model(name.replace('_no_buckets', ''), train)
    if name.endswith('no_buckets'):
        model.advance_stage()
    assert model.supports_fused_tables()
    named = _epoch(model, False, monkeypatch)
    fused = _epoch(model, True, monkeypatch)
    for key in named[0]:
        _assert_same(fused[0][key], named[0][key], key)
        assert fused[0][key].is_contiguous(), key
    assert len(fused[1]) == len(named[1])
    for i, (a, b) in enumerate(zip(fused[1], named[1])):
        _assert_same(a, b, f'optimizer state leaf {i}')
    _assert_same(fused[2], named[2], 'loss')


def _fit(model, fused_tables, monkeypatch, epochs=3):
    monkeypatch.setenv('COLLIE_TPU_FUSED_TABLES', '1' if fused_tables else '0')
    logger = EpochLossLogger()
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=3, logger=logger)
    trainer.fit(model)
    if model.current_stage == 'item_buckets':
        model.advance_stage()
        trainer.max_epochs += 2
        trainer.fit(model)
    return model, logger.epoch_losses


@pytest.mark.parametrize('name', ['mf', 'mf_dropout', 'mlp_mf', 'nonlinear_mf', 'neucf',
                                  'cold_start'])
def test_fit_fused_equals_named_bitwise(name, train, monkeypatch):
    """A 3-epoch fit (the whole fit); ColdStart 2 epochs in ``item_buckets``
    and 2 in ``no_buckets``, the bucket rows copied in between."""
    epochs = 2 if name == 'cold_start' else 3
    named, named_losses = _fit(_model(name, train), False, monkeypatch, epochs)
    fused, fused_losses = _fit(_model(name, train), True, monkeypatch, epochs)
    assert fused_losses == named_losses and len(named_losses) == (4 if name == 'cold_start'
                                                                  else 3)
    for key, value in named.params.items():
        _assert_same(fused.params[key], value, key)


@pytest.mark.parametrize('name', list(FUSED))
def test_fuse_and_unfuse_round_trip(name, train):
    model = _model(name, train)
    params = model.params
    fused = model.fuse_params(params)
    spec = model._FUSED_TABLE_SPEC
    assert set(fused) == (set(params) - {k for a, b, _ in spec for k in (a, b)}
                          | {f for _, _, f in spec})
    for first, second, fused_key in spec:
        width = params[first].shape[1] + (params[second].shape[1]
                                          if params[second].dim() == 2 else 1)
        assert tuple(fused[fused_key].shape) == (params[first].shape[0], width)
    back = model.unfuse_params(fused)
    assert set(back) == set(params)
    for key, value in params.items():
        assert torch.equal(back[key], value), key


def test_named_layout_models(train, monkeypatch):
    """bfloat16 tables cannot take a float32 bias column, and a model with
    no fused spec (DeepFM, CML, a subclass of MF) keeps its named tables;
    with the knob on their fits run on the named layout."""
    class Sub(collie_tpu_torch.MatrixFactorizationModel):
        pass

    monkeypatch.setenv('COLLIE_TPU_FUSED_TABLES', '1')
    loader = InteractionsDataLoader(interactions=train, batch_size=BATCH, seed=0)
    models = [_model('mf', train, embeddings_dtype='bfloat16'),
              _model('DeepFM', train, embedding_dim=6),
              _model('CollaborativeMetricLearningModel', train, embedding_dim=6, loss='hinge'),
              Sub(train=loader, embedding_dim=6, loss='adaptive', seed=3, map_location='cpu')]
    for model in models:
        assert not model.supports_fused_tables(), type(model).__name__
        specs = model.optimizer_specs()
        epoch_fn, _, _, _ = scan_engine.build_scan_epoch_fns(
            model, specs, [True] * len(specs), model.train_loader, shuffle=True, fused=False)
        assert epoch_fn.fused_tables is False
    CollieTrainer(models[0], max_epochs=1, verbosity=0, seed=3).fit(models[0])
    assert models[0].params['user_embeddings'].dtype == torch.bfloat16


def test_knob_flip_between_fits_takes_effect(train, monkeypatch):
    """``COLLIE_TPU_FUSED_TABLES`` is read where each fit builds its epoch
    functions: the first fit fuses, the second (knob 0) does not."""
    model = _model('mf', train)
    fuses = []
    original = model.fuse_params
    monkeypatch.setattr(model, 'fuse_params', lambda p: fuses.append(1) or original(p))
    CollieTrainer(model, max_epochs=1, verbosity=0, seed=3).fit(model)
    first = len(fuses)
    monkeypatch.setenv('COLLIE_TPU_FUSED_TABLES', '0')
    CollieTrainer(model, max_epochs=2, verbosity=0, seed=3).fit(model)
    assert first > 0 and len(fuses) == first


def test_fused_fit_saves_named_keys_that_collie_tpu_loads(train, tmp_path, monkeypatch):
    from collie_tpu.models.neural_collaborative_filtering import NeuralCollaborativeFiltering

    model, _ = _fit(_model('neucf', train), True, monkeypatch, epochs=1)
    path = tmp_path / 'neucf.npz'
    model.save_model(str(path))
    with np.load(path) as npz:
        keys = {k[len('param:'):] for k in npz.files if k.startswith('param:')}
    assert keys == set(model.params) and not any('fused' in k for k in keys)
    loaded = NeuralCollaborativeFiltering(load_model_path=str(path))
    for key, value in model.params.items():
        np.testing.assert_array_equal(np.asarray(loaded.params[key]), value.numpy(), key)


def test_default_fit_matches_jax_default_fit(monkeypatch):
    """The slice as a whole: MF, ``fused=False``, every knob at its default
    in both packages, on JAX's epoch draws; per-epoch losses within rtol
    1e-4 at lr 0.03."""
    from collie_tpu.data import stratified_split as jax_split
    from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
    from collie_tpu.training.trainer import CollieTrainer as JaxTrainer

    from tests.test_torch_training import DATA as TRAINING_DATA
    from tests.test_torch_training import jax_epoch_draws

    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    jax_train, _ = jax_split(jax_generate(**TRAINING_DATA), test_p=0.2, seed=1,
                             force_split=True)
    port_train, _ = collie_tpu_torch.stratified_split(
        generate_implicit_interactions(**TRAINING_DATA), test_p=0.2, seed=1, force_split=True)
    common = dict(embedding_dim=8, lr=0.03, loss='adaptive', seed=0)
    jax_model = JaxMF(train=jax_train, **common)
    model = collie_tpu_torch.MatrixFactorizationModel(train=port_train, map_location='cpu',
                                                      **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    losses = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model),
                                 ('port', CollieTrainer, model)):
        logger = EpochLossLogger()
        trainer_cls(m, max_epochs=3, verbosity=0, seed=0, logger=logger).fit(m)
        losses[name] = logger.epoch_losses
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-4, atol=0)
