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


def test_unported_paths_raise_not_implemented(data_pair, tmp_path):
    """Nothing of the trainer raises ``NotImplementedError`` any more: a
    trainer with a mesh constructs, and a ``.shards`` checkpoint arms a
    resume (mesh training and its checkpoints are held in
    ``test_torch_parallel_training.py`` and
    ``test_torch_sharded_checkpoint.py``); the paths the trainer slice
    ported (checkpoints, resume, the per-step path,
    ``CollieMinimalTrainer``) and embedding dropout run."""
    from collie_tpu_torch.parallel.checkpoint import save_sharded_pytree

    _, (train, _) = data_pair
    mesh = object()
    assert CollieTrainer(max_epochs=1, mesh=mesh).mesh is mesh
    shards = tmp_path / 'checkpoint_epoch_2.shards'
    save_sharded_pytree(shards, {'params': {'item_biases': torch.zeros(4)}, 'opt_states': ()},
                        {'epoch': 2})
    armed = CollieTrainer(max_epochs=1)
    assert armed.resume_from_checkpoint(shards) == 2
    assert armed._pending_resume == {'sharded_path': str(shards), 'epoch': 2}
    model = MatrixFactorizationModel(train=train, embedding_dim=8, seed=0, map_location='cpu',
                                     dropout_p=0.5)
    CollieTrainer(model, max_epochs=1, verbosity=0).fit(model)
    assert model.hparams['num_epochs_completed'] == 1
    trainer = CollieMinimalTrainer(model, max_epochs=2, verbosity=0, epoch_mode='step',
                                   checkpoint_dir=str(tmp_path))
    trainer.fit(model)
    assert isinstance(trainer, CollieTrainer)
    assert trainer.global_step == len(model.train_loader)
    assert (tmp_path / 'checkpoint_epoch_2.pkl').is_file()
    resumed = CollieTrainer(model, max_epochs=3, verbosity=0)
    assert resumed.resume_from_checkpoint(tmp_path / 'checkpoint_epoch_2.pkl') == 2
    resumed.fit(model)
    assert model.hparams['num_epochs_completed'] == 3


def test_hdf5_classes_construct_over_a_store(tmp_path):
    """The out-of-core tier is ported: ``HDF5Interactions`` and
    ``HDF5InteractionsDataLoader`` construct over a store and read it
    (their parity with collie_tpu is ``tests/test_torch_hdf5.py``)."""
    import pandas as pd

    from collie_tpu_torch import (HDF5Interactions, HDF5InteractionsDataLoader,
                                  pandas_df_to_hdf5)

    path = tmp_path / 'interactions.h5'
    pandas_df_to_hdf5(pd.DataFrame({'user_id': [0, 1, 2], 'item_id': [1, 0, 3]}), path)
    inter = HDF5Interactions(str(path), num_negative_samples=2, seed=0)
    assert (inter.num_users, inter.num_items, len(inter)) == (3, 4, 3)
    loader = HDF5InteractionsDataLoader(interactions=inter, batch_size=2)
    assert [int(b['mask'].sum()) for b in loader] == [2, 1]


def _slot_engaging_loader(drop_last):
    """512 users with 128 interactions each (n = 65,536): one 128-wide
    bucket, no pad slots, so the slot-domain epoch engages unless the
    loader drops its last partial batch."""
    from collie_tpu_torch import InteractionsDataLoader

    rng = np.random.default_rng(0)
    users = np.repeat(np.arange(512), 128)
    items = np.concatenate([rng.choice(1024, 128, replace=False) for _ in range(512)])
    inter = Interactions(users=users, items=items, num_users=512, num_items=1024,
                         allow_missing_ids=True, num_negative_samples=2, seed=0,
                         check_num_negative_samples_is_valid=False)
    return InteractionsDataLoader(inter, batch_size=1000, shuffle=True, drop_last=drop_last,
                                  seed=0)


@pytest.mark.parametrize('drop_last', [True, False])
def test_drop_last_truncates_the_slot_path_epoch(drop_last):
    """With ``drop_last`` the epoch is 65 whole batches: 65,000 examples
    train and are reported.  Without it the slot-domain epoch engages and
    trains all 65,536."""
    loader = _slot_engaging_loader(drop_last)
    model = MatrixFactorizationModel(train=loader, embedding_dim=4, seed=0, map_location='cpu')
    fn, data, S, n_used = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], loader, shuffle=True)
    batches = fn.epoch_batches(0, 1)
    mask_sum = float(batches['mask'].sum())
    if drop_last:
        assert 'packed_slots' not in data
        assert (S, n_used, mask_sum) == (65, 65_000, 65_000.0)
    else:
        assert 'packed_slots' in data
        assert (S, n_used, mask_sum) == (66, 65_536, 65_536.0)
    assert batches['users'].shape == (S, 1000)
