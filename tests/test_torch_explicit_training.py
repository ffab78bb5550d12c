"""The explicit training slice as a whole: the port's ``CollieTrainer.fit``
of an explicit MF and its ``explicit_evaluate_in_batches`` against
collie_tpu's, on the CPU.

Both fit the same MF (params carried across with ``params_from_jax``) on the
``explicit_sets`` fixture's data.  The port's epoch draws are JAX's: the
Feistel keys the JAX engine derives from ``fold_in(PRNGKey(seed), epoch)``
are handed to the port's ``scan_engine.draw_epoch``.  On the CPU both
packages train through their generic epochs.

Tolerances are those of ``tests/test_fused_epoch.py:92-95``: params within
``5e-4 * max|param|`` (the two engines sum duplicate-row gradients in
different orders, and Adam amplifies 1e-7 deltas over epochs), per-epoch
losses within ``rtol=1e-4``; learning rates must be equal.  Evaluations of
the same params agree to ``rtol=1e-5`` (the port sums on the device in
float64, JAX on the host from float32 batch sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.data import ExplicitInteractions as JaxExplicit
from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_interactions_df as jax_generate
from collie_tpu.evaluate import explicit_evaluate_in_batches as jax_explicit_evaluate
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieTrainer, ExplicitInteractions, Interactions,
                              MatrixFactorizationModel, explicit_evaluate_in_batches,
                              params_from_jax, stratified_split)
from collie_tpu_torch.data.synthetic import generate_interactions_df
from collie_tpu_torch.training import scan_engine

# the explicit_sets fixture's data (tests/fixtures/model_fixtures.py)
DATA = dict(num_users=250, num_items=500, num_interactions=20_000, seed=1)
EPOCHS = 3


def jax_explicit_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items,
                       exact):
    """The JAX engine's Feistel keys, as the port's ``draw_epoch`` returns
    them; an explicit epoch draws nothing else."""
    assert sample_shape is None
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx)
    perm_rng = jax.random.split(rng, 3 if training else 2)[0]
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    return keys, None


class Recorder:
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))


def _explicit(module, df):
    return module(users=df['user_id'].values, items=df['item_id'].values,
                  ratings=df['rating'].values, allow_missing_ids=True,
                  num_users=DATA['num_users'], num_items=DATA['num_items'])


@pytest.fixture(scope='module')
def data_pair():
    jax_sets = jax_split(_explicit(JaxExplicit, jax_generate(**DATA)), test_p=0.2, seed=1,
                         force_split=True)
    sets = stratified_split(_explicit(ExplicitInteractions, generate_interactions_df(**DATA)),
                            test_p=0.2, seed=1, force_split=True)
    return jax_sets, sets


def _fit_both(data_pair, monkeypatch, capsys, *, with_val=False, epochs=EPOCHS, **kwargs):
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_explicit_draws)
    (jax_train, jax_test), (train, test) = data_pair
    common = dict(embedding_dim=8, lr=1e-2, seed=0, **kwargs)
    jax_model = JaxMF(train=jax_train, val=jax_test if with_val else None, **common)
    model = MatrixFactorizationModel(train=train, val=test if with_val else None,
                                     map_location='cpu', **common)
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()}, 'cpu'))

    out = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        logger = Recorder()
        capsys.readouterr()
        trainer_cls(m, max_epochs=epochs, verbosity=1, seed=0, logger=logger,
                    enable_model_summary=False).fit(m)
        lines = capsys.readouterr().out.splitlines()
        out[name] = {
            'params': {k: np.asarray(v) for k, v in m.params.items()},
            'metrics': logger.metrics,
            'lr_lines': [line.strip() for line in lines if line.strip().startswith('lr[')],
            'epochs': m.hparams['num_epochs_completed'],
        }
    return out['jax'], out['port'], jax_model, model


def _assert_fits_agree(ref, port, keys=('train_loss_epoch',)):
    assert port['epochs'] == ref['epochs']
    assert [s for s, _ in port['metrics']] == [s for s, _ in ref['metrics']]
    for key in keys:
        np.testing.assert_allclose([m[key] for _, m in port['metrics']],
                                   [m[key] for _, m in ref['metrics']], rtol=1e-4, err_msg=key)
    for k, value in ref['params'].items():
        scale = max(np.abs(value).max(), 1e-3)
        np.testing.assert_allclose(port['params'][k], value, atol=5e-4 * scale, rtol=0,
                                   err_msg=f'param {k} diverged')
    assert port['lr_lines'] == ref['lr_lines']


@pytest.mark.parametrize('loss,y_range', [('mse', None), ('mae', None), ('mse', (1, 5))])
def test_explicit_fit_matches_jax_epoch_by_epoch(data_pair, monkeypatch, capsys, loss, y_range):
    ref, port, _, model = _fit_both(data_pair, monkeypatch, capsys, loss=loss, y_range=y_range)
    assert port['epochs'] == EPOCHS
    _assert_fits_agree(ref, port)
    # the user biases carry gradient under pointwise losses
    assert np.abs(port['params']['user_biases']).max() > 1e-4
    assert model.device.type == 'cpu'


def test_explicit_fit_with_val_and_weight_decay_matches_jax(data_pair, monkeypatch, capsys):
    """A validation loader (its own unshuffled epoch) monitored by the
    default plateau scheduler, ``y_range`` and weight decay.  (Not MAE with
    ``y_range`` here: from a fresh model every prediction is near 3 stars,
    the commonest rating, so ``sign(err)`` of some examples is decided by
    rounding; the kernel-level tests cover that pair from random tables.)"""
    ref, port, _, _ = _fit_both(data_pair, monkeypatch, capsys, with_val=True, loss='mse',
                                y_range=(1, 5), weight_decay=1e-3)
    _assert_fits_agree(ref, port, keys=('train_loss_epoch', 'val_loss_epoch'))


class MeanErrorMetric:
    """A stateful metric with the torchmetrics protocol."""

    def __init__(self):
        self.total, self.count, self.resets, self.types = 0.0, 0, 0, set()

    def update(self, preds, ratings):
        self.types.add(type(preds).__module__.split('.')[0])
        self.total += float((preds - ratings).sum())
        self.count += len(ratings)

    def compute(self):
        return self.total / self.count

    def reset(self):
        self.total, self.count = 0.0, 0
        self.resets += 1


def test_explicit_evaluate_matches_jax(data_pair, monkeypatch, capsys):
    """The same trained params in both packages: ``'mse'``, ``'mae'``, a
    stateful metric object and a plain callable agree, with a batch size
    that leaves a padded last batch."""
    _, _, jax_model, model = _fit_both(data_pair, monkeypatch, capsys, epochs=1, loss='mse',
                                       y_range=(1, 5))
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()}, 'cpu'))
    (_, jax_test), (_, test) = data_pair
    seen = []

    def cubed_error(preds, ratings):
        seen.append((type(preds), type(ratings)))
        return float(np.mean(np.abs(preds - ratings) ** 3))

    results = {}
    for name, fn, m, inter in (('jax', jax_explicit_evaluate, jax_model, jax_test),
                               ('port', explicit_evaluate_in_batches, model, test)):
        stateful = MeanErrorMetric()
        logger = Recorder()
        scores = fn(['mse', 'mae', stateful, cubed_error], inter, m, logger=logger,
                    verbose=False, batch_size=999)
        assert stateful.resets == 1 and stateful.count == 0
        results[name] = (scores, stateful.types, logger.metrics)
    np.testing.assert_allclose(results['port'][0], results['jax'][0], rtol=1e-5)
    assert results['port'][1] == {'torch'} and results['jax'][1] == {'numpy'}
    assert seen == [(np.ndarray, np.ndarray)] * 2
    assert [s for s, _ in results['port'][2]] == [s for s, _ in results['jax'][2]]
    assert sorted(results['port'][2][0][1]) == sorted(results['jax'][2][0][1])
    single = explicit_evaluate_in_batches(['mse'], test, model)
    assert single == pytest.approx(results['port'][0][0], rel=1e-12)


def test_explicit_evaluate_rejects_implicit_data_with_the_jax_message(data_pair):
    kw = dict(users=[0, 1, 2], items=[0, 1, 2], num_negative_samples=1)
    _, (train, _) = data_pair
    model = MatrixFactorizationModel(train=train, embedding_dim=4, loss='mse', seed=0,
                                     map_location='cpu')
    messages = []
    for fn, inter, m in ((jax_explicit_evaluate, JaxInteractions(**kw), None),
                         (explicit_evaluate_in_batches, Interactions(**kw), model)):
        with pytest.raises(ValueError) as err:
            fn(['mse'], inter, m)
        messages.append(str(err.value).replace('collie_tpu_torch', 'collie_tpu'))
    assert messages[0] == messages[1]
    assert 'Try using ``evaluate_in_batches`` instead.' in messages[1]
    with pytest.raises(ValueError, match='Unrecognized explicit metric'):
        explicit_evaluate_in_batches(['rmse'], data_pair[1][1], model)


def test_fit_then_predict_stars(data_pair):
    """The quickstart's last step: ``model(users, items)`` gives stars in
    ``y_range`` after an explicit fit, which records its epoch split."""
    _, (train, _) = data_pair
    model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-2, loss='mse',
                                     y_range=(1, 5), seed=0, map_location='cpu')
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0)
    trainer.fit(model)
    assert [e['epoch'] for e in trainer.epoch_log] == [1, 2]
    assert all(e['shuffle_ms'] > 0 and e['sample_ms'] > 0 and e['train_ms'] > 0
               for e in trainer.epoch_log)
    stars = model([0] * 5, list(range(5)))
    assert stars.shape == (5,) and np.all((stars > 1) & (stars < 5))
