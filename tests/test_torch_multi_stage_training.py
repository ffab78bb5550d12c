"""Fits through every stage, and serving, of the multi-stage models: the
port's ``CollieTrainer`` and retrieval against collie_tpu's on the CPU.

Pairs as in ``tests/test_torch_multi_stage.py``, trained from a loader of
batch 64 (7 steps an epoch).  Both packages fit one epoch a stage on JAX's
epoch draws (``draw_epoch`` patched as in ``tests/test_torch_training.py``;
epochs keep their numbers across stages), JAX on its dense branch
(``COLLIE_TPU_SPARSE_ADAPTIVE=0``): ColdStart ``item_buckets`` then
``no_buckets``, Hybrid ``matrix_factorization``, ``metadata_only``,
``all``, HybridPretrained frozen then unfrozen.  After every epoch the
loss agrees within rtol 1e-4 and the params within ``5e-4 * max|param|``
(``tests/test_torch_training.py``'s tolerance: the engines sum duplicate
rows' gradients in different orders and Adam amplifies the difference).
One param is held differently: the combined MLP's output bias of the
hybrids adds to the positive and the negative scores alike, so a pairwise
loss gives it a gradient that is zero up to rounding (held to ``jax.grad``
in ``tests/test_torch_hybrid.py``), which Adam scales into steps of
``+-lr``; the two rounding trajectories are not compared, and instead the
spec that trains it must be JAX's: name, stage, keys, learning rate and
optimizer kind.  The tables a stage gates out come out of its fit bitwise
unchanged, and the donor of HybridPretrained is untouched.  ``recommend`` ids (the
blockwise path) are equal to JAX's, scores and ``evaluate_in_batches``
metrics within rtol 1e-5 / atol 1e-6.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from collie_tpu.evaluate import evaluate_in_batches as jax_evaluate
from collie_tpu.ops import auc as jax_auc
from collie_tpu.ops import mapk as jax_mapk
from collie_tpu.ops import mrr as jax_mrr
from collie_tpu.retrieval import recommend as jax_recommend
from collie_tpu.training.optimizers import get_lr as jax_get_lr
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import CollieTrainer, auc, evaluate_in_batches, mapk, mrr, recommend
from collie_tpu_torch.training import scan_engine, trainer as trainer_module
from collie_tpu_torch.training.optimizers import get_lr

from tests.test_torch_multi_stage import (DATA, SCORE_TOL, build_donors,  # noqa: F401
                                          build_pair, data, set_stage)
from tests.test_torch_training import jax_epoch_draws

MODELS = ['ColdStartModel', 'HybridModel', 'HybridPretrainedModel']


class LossLog:
    def __init__(self):
        self.losses = []

    def log_metrics(self, metrics, step):
        self.losses.append((step, metrics['train_loss_epoch']))


def stage_plan(name, model):
    """``(label, enter)`` per stage: ``enter(m)`` moves a model into it."""
    if name == 'HybridPretrainedModel':
        return [('frozen', lambda m: None), ('unfrozen', lambda m: m.unfreeze_embeddings())]
    stages = model.hparams['stage_list']
    return [(stage, lambda m, stage=stage: set_stage(stage, m)) for stage in stages]


def trained_keys(model):
    specs = model.optimizer_specs()
    return {k for spec in specs if spec.stage in (None, model.current_stage) for k in spec.keys}


def cancelling_keys(model):
    """Params whose pairwise-loss gradient is zero up to rounding: the
    hybrids' output bias."""
    n = getattr(model, 'n_combined_layers', None)
    return {f'combined_layer_{n - 1}_bias'} if n else set()


def active_spec(model, key):
    """The one optimizer spec that trains ``key`` in the current stage."""
    (spec,) = [spec for spec in model.optimizer_specs()
               if key in spec.keys and spec.stage in (None, model.current_stage)]
    return spec


def assert_spec_matches_jax(jax_model, model, key, label):
    """The port trains ``key`` with JAX's spec: name, stage, keys, learning
    rate (both as stored in a fresh optimizer state) and optimizer kind."""
    jax_spec, spec = active_spec(jax_model, key), active_spec(model, key)
    assert (spec.name, spec.stage, sorted(spec.keys)) \
        == (jax_spec.name, jax_spec.stage, sorted(jax_spec.keys)), (label, key)
    jax_state = jax_spec.transform.init({k: jax_model.params[k] for k in jax_spec.keys})
    state = spec.transform.init({k: model.params[k] for k in spec.keys})
    assert get_lr(state) == jax_get_lr(jax_state), (label, key)
    jax_adam = any(isinstance(s, optax.ScaleByAdamState) for s in jax.tree_util.tree_leaves(
        jax_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)))
    assert spec.transform.is_adam == jax_adam, (label, key)


def assert_params_close(jax_model, model, label, skip=()):
    for k, ref in jax_model.params.items():
        if k in skip:
            continue
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(model.params[k].numpy(), ref, atol=5e-4 * scale, rtol=0,
                                   err_msg=f'{label}: param {k} diverged')


@pytest.mark.parametrize('name', MODELS)
def test_fit_through_every_stage_matches_jax(name, data, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    donors = build_donors(data, loader=True) if name == 'HybridPretrainedModel' else None
    donor_before = donors and {k: v.clone() for k, v in donors[1].params.items()}
    jax_donor_before = donors and {k: np.asarray(v).copy() for k, v in donors[0].params.items()}
    jax_model, model = build_pair(name, data, loader=True, donors=donors)
    logs = LossLog(), LossLog()
    jax_trainer = JaxTrainer(jax_model, max_epochs=1, verbosity=0, seed=0, logger=logs[0])
    trainer = CollieTrainer(model, max_epochs=1, verbosity=0, seed=0, logger=logs[1])
    for epoch, (label, enter) in enumerate(stage_plan(name, model), start=1):
        enter(jax_model)
        enter(model)
        if name == 'HybridModel':       # the JAX tests' idiom
            jax_trainer.max_epochs = trainer.max_epochs = epoch
        elif epoch > 1:                 # and the other one
            jax_trainer.max_epochs += 1
            trainer.max_epochs += 1
        gated = {k: v.clone() for k, v in model.params.items() if k not in trained_keys(model)}
        jax_gated = {k: np.asarray(jax_model.params[k]).copy() for k in gated}
        cancelling = cancelling_keys(model) & trained_keys(model)
        jax_trainer.fit(jax_model)
        trainer.fit(model)
        assert model.hparams['num_epochs_completed'] == jax_model.hparams['num_epochs_completed'] \
            == epoch
        (jax_step, jax_loss), (step, loss) = logs[0].losses[-1], logs[1].losses[-1]
        assert step == jax_step == epoch and len(logs[1].losses) == epoch
        np.testing.assert_allclose(loss, jax_loss, rtol=1e-4, err_msg=label)
        assert_params_close(jax_model, model, label, skip=cancelling)
        for k in cancelling:
            assert_spec_matches_jax(jax_model, model, k, label)
        for k, value in gated.items():
            assert torch.equal(model.params[k], value), f'{label}: gated {k} changed'
            np.testing.assert_array_equal(np.asarray(jax_model.params[k]), jax_gated[k])
        if name == 'ColdStartModel' and label == 'item_buckets':
            assert {'item_embeddings', 'item_biases'} <= set(gated)
        if name == 'HybridModel' and label == 'metadata_only':
            assert {'item_embeddings', 'user_embeddings'} <= set(gated)
        if label == 'frozen':
            assert set(gated) == {'item_embeddings', 'user_embeddings'}
    if donors:
        for k, value in donor_before.items():
            assert torch.equal(donors[1].params[k], value)
            np.testing.assert_array_equal(np.asarray(donors[0].params[k]), jax_donor_before[k])


def test_optimizer_state_resets_at_each_fit(data, monkeypatch):
    """Each fit starts every optimizer from a fresh state (count 0, zero
    moments), also after a stage change."""
    starts = []
    build = trainer_module.build_scan_epoch_fns

    def recording(*args, training=True, **kwargs):
        fn, *rest = build(*args, training=training, **kwargs)
        if not training:
            return (fn, *rest)

        def epoch_fn(params, opt_states, *more):
            starts.append(opt_states)
            return fn(params, opt_states, *more)

        epoch_fn.split_ms = fn.split_ms
        return (epoch_fn, *rest)

    monkeypatch.setattr(trainer_module, 'build_scan_epoch_fns', recording)
    _, model = build_pair('ColdStartModel', data, loader=True)
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0, seed=0)
    trainer.fit(model)
    model.advance_stage()
    trainer.max_epochs = 3
    trainer.fit(model)
    assert len(starts) == 3
    for first in (starts[0], starts[2]):
        for state in first:
            assert state.count == 0 and int(state.adam_count) == 0
            assert all(not v.any() for v in state.mu.values())
    assert starts[1][0].count > 0


@pytest.mark.parametrize('name', MODELS)
def test_no_fused_epoch_for_multi_stage_models(name, data):
    """The fused kernel's gate takes only ``MatrixFactorizationModel`` (as
    JAX's), so each stage of these models trains through the generic
    epoch, ColdStart's MF-shaped ``no_buckets`` stage included."""
    _, model = build_pair(name, data, loader=True)
    for label, enter in stage_plan(name, model):
        enter(model)
        specs = model.optimizer_specs()
        active = [spec.stage in (None, model.current_stage) for spec in specs]
        assert scan_engine._fused_epoch_config(model, specs, active, model.train_loader) is None
        with pytest.raises(ValueError, match='envelope'):
            scan_engine.build_scan_epoch_fns(model, specs, active, model.train_loader,
                                             shuffle=True, fused=True)


@pytest.mark.parametrize('name', ['HybridModel', 'HybridPretrainedModel'])
def test_gated_tables_stay_unchanged_with_dropout(name, data):
    """With dropout too, the embeddings of Hybrid's ``metadata_only`` stage
    and HybridPretrained's frozen embeddings come out bitwise unchanged."""
    _, model = build_pair(name, data, loader=True, dropout_p=0.2)
    set_stage('metadata_only' if name == 'HybridModel' else None, model)
    before = {k: model.params[k].clone() for k in ('user_embeddings', 'item_embeddings')}
    others = {k: v.clone() for k, v in model.params.items() if k not in before}
    CollieTrainer(model, max_epochs=1, verbosity=0, seed=0).fit(model)
    for k, value in before.items():
        assert torch.equal(model.params[k], value)
    assert not torch.equal(model.params['combined_layer_0_weight'],
                           others['combined_layer_0_weight'])


@pytest.mark.parametrize('name', MODELS)
def test_recommend_and_evaluate_match_jax(name, data):
    """In the final stage: ``recommend`` (the blockwise path, through the
    default catalog hook, with and without seen filtering) and
    ``evaluate_in_batches``."""
    jax_model, model = build_pair(name, data)
    final = model.hparams['stage_list'][-1] if 'stage_list' in model.hparams else None
    set_stage(final, jax_model, model)
    (_, jax_test), (_, test) = data['jax'], data['torch']
    users = np.arange(0, DATA['num_users'], 3)
    for filter_seen in (True, False):
        jax_ids, jax_scores = jax_recommend(jax_model, users, k=7, filter_seen=filter_seen,
                                            item_tile=8)
        ids, scores = recommend(model, users, k=7, filter_seen=filter_seen, item_tile=8)
        np.testing.assert_array_equal(ids, np.asarray(jax_ids))
        np.testing.assert_allclose(scores, np.asarray(jax_scores), **SCORE_TOL)
    ref = jax_evaluate([jax_mapk, jax_mrr, jax_auc], jax_test, jax_model, k=5, verbose=False)
    got = evaluate_in_batches([mapk, mrr, auc], test, model, k=5, verbose=False)
    np.testing.assert_allclose(got, ref, **SCORE_TOL)
