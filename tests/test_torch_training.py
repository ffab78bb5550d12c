"""The training slice as a whole: the port's ``CollieTrainer.fit`` against
collie_tpu's on the CPU.

Both fit the same MF (params carried across with ``params_from_jax``) on the
``implicit_train`` fixture's data for 3 epochs.  The port's epoch draws are
JAX's: the Feistel keys and sampler uniforms that the JAX engine derives
from ``fold_in(PRNGKey(seed), epoch)`` are handed to the port's
``scan_engine.draw_epoch``.  JAX runs the dense adaptive computation
(``COLLIE_TPU_SPARSE_ADAPTIVE=0``), the form the port implements.

Tolerances are those of ``tests/test_fused_epoch.py:92-95``: params within
``5e-4 * max|param|`` (the two engines sum duplicate-row gradients in
different orders, and Adam amplifies 1e-7 deltas over epochs), per-epoch
losses within ``rtol=1e-4``; learning rates must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.schedulers import StepLR as JaxStepLR
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieMinimalTrainer, CollieTrainer, Interactions,
                              MatrixFactorizationModel, StepLR, params_from_jax,
                              stratified_split)
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.training import scan_engine

# the implicit_train fixture's data (tests/fixtures/model_fixtures.py)
DATA = dict(num_users=250, num_items=500, num_interactions=20_000, seed=1)
EPOCHS = 3


def jax_epoch_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items,
                    exact):
    """The JAX engine's epoch draws, as the port's ``draw_epoch`` returns them."""
    assert exact, 'the parity fits use exact sampling'
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx)
    if training:
        perm_rng, sample_rng, _ = jax.random.split(rng, 3)
    else:
        perm_rng, sample_rng = jax.random.split(rng)
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    u01 = torch.from_numpy(np.array(jax.random.uniform(sample_rng, sample_shape)))
    return keys, u01


class Recorder:
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))


@pytest.fixture(scope='module')
def data_pair():
    jax_train, jax_test = jax_split(jax_generate(**DATA), test_p=0.2, seed=1,
                                    force_split=True)
    train, test = stratified_split(generate_implicit_interactions(**DATA), test_p=0.2,
                                   seed=1, force_split=True)
    return (jax_train, jax_test), (train, test)


def _fit_both(data_pair, monkeypatch, capsys, *, with_val=False, scheduler=None,
              loss='adaptive', epochs=EPOCHS, **kwargs):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    (jax_train, jax_test), (train, test) = data_pair
    common = dict(embedding_dim=8, lr=1e-1, loss=loss, seed=0, **kwargs)
    jax_sched, sched = {}, {}
    if scheduler is not None:
        jax_sched = {'lr_scheduler_func': JaxStepLR(*scheduler)}
        sched = {'lr_scheduler_func': StepLR(*scheduler)}
    jax_model = JaxMF(train=jax_train, val=jax_test if with_val else None, **common,
                      **jax_sched)
    model = MatrixFactorizationModel(train=train, val=test if with_val else None,
                                     map_location='cpu', **common, **sched)
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
            'params': {k: np.asarray(v.float() if torch.is_tensor(v) else v)
                       for k, v in m.params.items()},
            'metrics': logger.metrics,
            'lr_lines': [line.strip() for line in lines if line.strip().startswith('lr[')],
            'epochs': m.hparams['num_epochs_completed'],
        }
    return out['jax'], out['port'], model


def _assert_params_close(jax_params, port_params):
    for k, ref in jax_params.items():
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(port_params[k], ref, atol=5e-4 * scale, rtol=0,
                                   err_msg=f'param {k} diverged')


@pytest.mark.parametrize('loss', ['adaptive', 'warp'])
def test_fit_matches_jax_epoch_by_epoch(data_pair, monkeypatch, capsys, loss):
    ref, port, model = _fit_both(data_pair, monkeypatch, capsys, loss=loss)
    assert port['epochs'] == ref['epochs'] == EPOCHS
    assert [s for s, _ in port['metrics']] == [s for s, _ in ref['metrics']]
    np.testing.assert_allclose([m['train_loss_epoch'] for _, m in port['metrics']],
                               [m['train_loss_epoch'] for _, m in ref['metrics']], rtol=1e-4)
    _assert_params_close(ref['params'], port['params'])
    assert port['lr_lines'] == ref['lr_lines']
    assert model.device.type == 'cpu'


def test_fit_with_val_and_lr_schedule_matches_jax(data_pair, monkeypatch, capsys):
    """A validation loader (its own unshuffled epoch and draws) and a StepLR
    that halves both learning rates every epoch."""
    ref, port, _ = _fit_both(data_pair, monkeypatch, capsys, with_val=True,
                             scheduler=(1, 0.5))
    for key in ('train_loss_epoch', 'val_loss_epoch'):
        np.testing.assert_allclose([m[key] for _, m in port['metrics']],
                                   [m[key] for _, m in ref['metrics']], rtol=1e-4, err_msg=key)
    _assert_params_close(ref['params'], port['params'])
    assert len(port['lr_lines']) == 2 * EPOCHS
    assert port['lr_lines'] == ref['lr_lines']


def test_fit_with_weight_decay_matches_jax(data_pair, monkeypatch, capsys):
    ref, port, _ = _fit_both(data_pair, monkeypatch, capsys, loss='bpr', epochs=1,
                             weight_decay=1e-3)
    np.testing.assert_allclose(port['metrics'][0][1]['train_loss_epoch'],
                               ref['metrics'][0][1]['train_loss_epoch'], rtol=1e-4)
    _assert_params_close(ref['params'], port['params'])


def _slot_domain_pair():
    """Every user has 64 interactions: one 128-wide bucket and no pad slots,
    so both engines take the slot-domain one-gather epoch."""
    rng = np.random.default_rng(0)
    users = np.repeat(np.arange(64), 64)
    items = np.concatenate([rng.choice(512, 64, replace=False) for _ in range(64)])
    kw = dict(users=users, items=items.astype(np.int64), allow_missing_ids=True,
              num_users=64, num_items=512, num_negative_samples=5, seed=0,
              check_num_negative_samples_is_valid=False)
    return JaxInteractions(**kw), Interactions(**kw)


def test_slot_domain_fit_matches_jax(monkeypatch):
    from collie_tpu.data import InteractionsDataLoader as JaxLoader
    from collie_tpu_torch import InteractionsDataLoader

    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    jax_inter, inter = _slot_domain_pair()
    jax_model = JaxMF(train=JaxLoader(jax_inter, batch_size=500, shuffle=True, seed=0),
                      embedding_dim=8, lr=1e-1, loss='adaptive', seed=0)
    model = MatrixFactorizationModel(
        train=InteractionsDataLoader(inter, batch_size=500, shuffle=True, seed=0),
        embedding_dim=8, lr=1e-1, loss='adaptive', seed=0, map_location='cpu')
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()}, 'cpu'))
    specs = model.optimizer_specs()
    fn, data, S, n_used = scan_engine.build_scan_epoch_fns(
        model, specs, [True, True], model.train_loader, shuffle=True)
    assert 'packed_slots' in data and 'pos_of' not in data
    assert S == 9 and n_used == 64 * 64        # 4096 slots -> 8 full steps + a tail
    JaxTrainer(jax_model, max_epochs=2, verbosity=0, seed=0).fit(jax_model)
    CollieTrainer(model, max_epochs=2, verbosity=0, seed=0).fit(model)
    _assert_params_close({k: np.asarray(v) for k, v in jax_model.params.items()},
                         {k: v.numpy() for k, v in model.params.items()})


def test_fit_records_epoch_split_and_throughput(data_pair):
    _, (train, _) = data_pair
    model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-1, seed=0,
                                     map_location='cpu')
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0)
    trainer.fit(model)
    assert [e['epoch'] for e in trainer.epoch_log] == [1, 2]
    assert all(e['shuffle_ms'] > 0 and e['sample_ms'] > 0 and e['train_ms'] > 0
               for e in trainer.epoch_log)
    assert trainer.last_fit_examples_per_sec > 0
    assert model.hparams['num_epochs_completed'] == 2
    # a second fit continues the epoch numbering
    CollieTrainer(model, max_epochs=3, verbosity=0).fit(model)
    assert model.hparams['num_epochs_completed'] == 3


class _ScriptedEpochs:
    """A stand-in epoch function returning scripted losses."""

    def __init__(self, losses):
        self.losses = list(losses)

    def __call__(self, params, opt_states, data, seed, epoch):
        return params, opt_states, torch.tensor(self.losses[epoch - 1])

    def split_ms(self):
        return {'shuffle_ms': 0.0, 'sample_ms': 0.0, 'train_ms': 0.0}


def _run_scripted(losses, **trainer_kwargs):
    model = MatrixFactorizationModel(
        train=Interactions(users=[0, 0, 1, 1, 2], items=[0, 1, 1, 2, 3],
                           num_negative_samples=1),
        embedding_dim=4, seed=0, map_location='cpu', lr_scheduler_func=None)
    trainer = CollieTrainer(model, max_epochs=len(losses), verbosity=0, **trainer_kwargs)
    specs = model.optimizer_specs()
    state = {'params': dict(model.params),
             'opt_states': tuple(s.transform.init({k: model.params[k] for k in s.keys})
                                 for s in specs),
             'total_examples': 0}
    trainer._run_epochs(model=model, specs=specs, schedulers=[None, None], start_epoch=1,
                        train_fn=_ScriptedEpochs(losses), train_data=None, train_examples=5,
                        val_fn=None, val_data=None, state=state)
    return trainer, model


def test_early_stopping_counts_non_improving_epochs():
    trainer, model = _run_scripted([1.0, 0.5, 0.6, 0.7, 0.4], early_stopping_patience=2)
    assert trainer.num_epochs_completed == 4
    assert trainer.best_epoch_loss == (2, 0.5)
    assert model.hparams['num_epochs_completed'] == 4
    trainer, _ = _run_scripted([1.0, 0.5, 0.6, 0.7, 0.4])
    assert trainer.num_epochs_completed == 5


def test_terminate_on_nan_trips_before_counting_the_epoch():
    with pytest.raises(FloatingPointError, match='epoch 2'):
        _run_scripted([1.0, float('nan'), 0.5], terminate_on_nan=True)
    trainer, _ = _run_scripted([1.0, float('nan'), 0.5])
    assert trainer.num_epochs_completed == 3


def test_nan_params_trip_a_real_fit(data_pair):
    _, (train, _) = data_pair
    model = MatrixFactorizationModel(train=train, embedding_dim=8, seed=0, map_location='cpu')
    params = dict(model.params)
    params['item_embeddings'] = torch.full_like(params['item_embeddings'], float('nan'))
    model.load_params(params)
    with pytest.raises(FloatingPointError, match='epoch 1'):
        CollieTrainer(model, max_epochs=2, verbosity=0, terminate_on_nan=True).fit(model)
    assert model.hparams['num_epochs_completed'] == 0


def test_unported_paths_raise_not_implemented(data_pair):
    _, (train, _) = data_pair
    for kwargs in ({'mesh': object()}, {'checkpoint_dir': 'ckpt'}, {'epoch_mode': 'step'}):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            CollieTrainer(max_epochs=1, **kwargs)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        CollieTrainer(max_epochs=1).resume_from_checkpoint('x')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        CollieMinimalTrainer(max_epochs=1)
    model = MatrixFactorizationModel(train=train, embedding_dim=8, seed=0, map_location='cpu',
                                     dropout_p=0.5)
    with pytest.raises(NotImplementedError, match='dropout'):
        CollieTrainer(model, max_epochs=1, verbosity=0).fit(model)
