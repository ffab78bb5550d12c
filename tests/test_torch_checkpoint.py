"""Checkpoint/resume of the port's trainer, and the JAX package's
checkpoints read by the port, on the CPU.

A resumed fit must equal an uninterrupted one at JAX's own tolerance
(rtol 1e-6, atol 1e-7, ``tests/test_checkpointing.py:52``), through the
generic epoch and through the fused epoch's plain version.  A checkpoint
written by collie_tpu resumes in the port with every field equal, and two
more epochs in step mode then match JAX's two more at the tolerance of
``tests/test_torch_training.py`` (params within ``5e-4 * max|param|``,
losses within rtol 1e-4: the engines sum duplicate-row gradients in
different orders).  The reader imports nothing: a subprocess with ``jax``,
``jaxlib``, ``optax``, ``ml_dtypes`` and ``collie_tpu`` blocked loads the
file, and a pickle naming any other global is refused.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from collie_tpu.data import InteractionsDataLoader as JaxLoader
from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.schedulers import ReduceLROnPlateau as JaxPlateau
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieTrainer, Interactions, InteractionsDataLoader,
                              MatrixFactorizationModel, ReduceLROnPlateau, read_checkpoint)
from collie_tpu_torch.training import trainer as trainer_module
from collie_tpu_torch.training.trainer import state_leaves

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(num_users=60, num_items=120, num_interactions=1500)


def _arrays(seed=1):
    rng = np.random.default_rng(seed)
    return dict(users=rng.integers(0, DATA['num_users'], DATA['num_interactions']),
                items=rng.integers(0, DATA['num_items'], DATA['num_interactions']),
                num_users=DATA['num_users'], num_items=DATA['num_items'],
                allow_missing_ids=True, num_negative_samples=3, seed=0,
                check_num_negative_samples_is_valid=False)


def _model(module=None, scheduler=False, **kwargs):
    """A port MF (``module`` None) or a JAX one on the same data, with a
    shuffling loader of batch 256."""
    plateau = (lambda: (JaxPlateau if module else ReduceLROnPlateau)(patience=0, factor=0.5))
    inter = (JaxInteractions if module else Interactions)(**_arrays())
    loader = (JaxLoader if module else InteractionsDataLoader)(inter, batch_size=256,
                                                               shuffle=True, seed=0)
    common = dict(train=loader, embedding_dim=4, lr=1e-2, loss='adaptive', seed=0,
                  lr_scheduler_func=plateau if scheduler else None)
    common.update(kwargs)
    if module:
        return JaxMF(**common)
    return MatrixFactorizationModel(map_location='cpu', **common)


def _params(model):
    return {k: np.asarray(v.float() if torch.is_tensor(v) else v)
            for k, v in model.params.items()}


@pytest.mark.parametrize('every', [1, 2, 3])
def test_checkpoint_files_written_at_the_right_epochs(tmp_path, every):
    model = _model()
    CollieTrainer(model, max_epochs=4, verbosity=0, checkpoint_dir=str(tmp_path),
                  checkpoint_every_n_epochs=every).fit(model)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f'checkpoint_epoch_{e}.pkl' for e in range(1, 5) if e % every == 0]
    ckpt = read_checkpoint(tmp_path / files[-1])
    assert sorted(ckpt) == ['best_epoch_loss', 'epoch', 'global_step', 'opt_states',
                            'params', 'schedulers']
    assert all(isinstance(v, np.ndarray) for v in ckpt['params'].values())


@pytest.mark.parametrize('fused', [False, True])
def test_resume_reproduces_uninterrupted_run(tmp_path, monkeypatch, fused):
    """2 epochs, a checkpoint, then 2 more in a fresh model and trainer
    equal 4 uninterrupted epochs (``fused=True``: the fused epoch's plain
    version on the CPU)."""
    if fused:
        monkeypatch.setattr(trainer_module, 'build_scan_epoch_fns', functools.partial(
            trainer_module.build_scan_epoch_fns, fused=True))
    model_a = _model()
    CollieTrainer(model_a, max_epochs=4, verbosity=0, seed=0).fit(model_a)
    model_b = _model()
    trainer_b = CollieTrainer(model_b, max_epochs=2, verbosity=0, seed=0,
                              checkpoint_dir=str(tmp_path), checkpoint_every_n_epochs=2)
    trainer_b.fit(model_b)
    model_c = _model()
    trainer_c = CollieTrainer(model_c, max_epochs=4, verbosity=0, seed=0)
    assert trainer_c.resume_from_checkpoint(tmp_path / 'checkpoint_epoch_2.pkl') == 2
    trainer_c.fit(model_c)
    assert model_c.hparams['num_epochs_completed'] == 4
    for key, ref in _params(model_a).items():
        np.testing.assert_allclose(_params(model_c)[key], ref, rtol=1e-6, atol=1e-7,
                                   err_msg=f'resume divergence in {key}')


def test_resume_restores_scheduler_and_counters(tmp_path, capsys):
    """A plateau scheduler that fires every epoch: the resumed fit prints
    the same learning-rate steps and ends on the same params as the
    uninterrupted one, and its checkpoint holds the scheduler's state."""
    def fit(model, trainer, resume=None):
        if resume:
            trainer.resume_from_checkpoint(resume)
        capsys.readouterr()
        trainer.fit(model)
        return [line.strip() for line in capsys.readouterr().out.splitlines()
                if line.strip().startswith('lr[')]

    model_a = _model(scheduler=True, lr=1e-6)
    lines_a = fit(model_a, CollieTrainer(model_a, max_epochs=4, seed=0,
                                         enable_model_summary=False))
    model_b = _model(scheduler=True, lr=1e-6)
    trainer_b = CollieTrainer(model_b, max_epochs=3, seed=0, enable_model_summary=False,
                              checkpoint_dir=str(tmp_path))
    lines_b = fit(model_b, trainer_b)
    ckpt = read_checkpoint(tmp_path / 'checkpoint_epoch_3.pkl')
    assert ckpt['schedulers'][0]['num_bad_epochs'] == 0 and ckpt['schedulers'][0]['best'] > 0
    assert (ckpt['epoch'], ckpt['global_step']) == (3, 0)
    model_c = _model(scheduler=True, lr=1e-6)
    trainer_c = CollieTrainer(model_c, max_epochs=4, seed=0, enable_model_summary=False)
    lines_c = fit(model_c, trainer_c, tmp_path / 'checkpoint_epoch_3.pkl')
    assert lines_b + lines_c == lines_a and len(lines_a) >= 2
    assert trainer_c.best_epoch_loss[0] == 4
    for key, ref in _params(model_a).items():
        np.testing.assert_allclose(_params(model_c)[key], ref, rtol=1e-6, atol=1e-7)


def test_checkpoint_holds_the_live_state(tmp_path):
    model = _model(scheduler=True)
    trainer = CollieTrainer(model, max_epochs=1, verbosity=0, checkpoint_dir=str(tmp_path))
    trainer.fit(model)
    ckpt = read_checkpoint(tmp_path / 'checkpoint_epoch_1.pkl')
    for k, v in model.params.items():
        np.testing.assert_array_equal(ckpt['params'][k], v.numpy())
    fresh = CollieTrainer(model, max_epochs=1, verbosity=0)
    specs = model.optimizer_specs()
    inits = tuple(s.transform.init({k: model.params[k] for k in s.keys}) for s in specs)
    params, states, schedulers = fresh._restore(model, ckpt, inits,
                                                [ReduceLROnPlateau(), ReduceLROnPlateau()])
    for saved, state in zip(ckpt['opt_states'], states):
        for a, b in zip(saved, state_leaves(state)):
            if torch.is_tensor(b):
                np.testing.assert_array_equal(a, b.numpy())
            else:
                assert a == b
    assert states[0].adam_count.dtype == torch.int32 and int(states[0].adam_count) == 6
    assert isinstance(schedulers[0], ReduceLROnPlateau)
    assert (fresh.global_step, fresh.best_epoch_loss) == (0, (-1, float('inf')))


def test_bfloat16_tables_travel_as_bits(tmp_path):
    model = _model(embeddings_dtype='bfloat16')
    CollieTrainer(model, max_epochs=1, verbosity=0, checkpoint_dir=str(tmp_path)).fit(model)
    ckpt = read_checkpoint(tmp_path / 'checkpoint_epoch_1.pkl')
    bits = ckpt['params']['user_embeddings']['__bfloat16_bits__']
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(
        bits, model.params['user_embeddings'].view(torch.int16).numpy().view(np.uint16))


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
    """JAX checkpoints after 2 epochs: float32 tables with a plateau
    scheduler, and bfloat16 tables with weight decay."""
    out = {}
    for dtype, extra in (('float32', dict(scheduler=True)),
                         ('bfloat16', dict(embeddings_dtype='bfloat16', weight_decay=1e-3))):
        path = tmp_path_factory.mktemp(dtype)
        model = _model(module='jax', **extra)
        JaxTrainer(model, max_epochs=2, verbosity=0, seed=0, checkpoint_dir=str(path)).fit(model)
        out[dtype] = path / 'checkpoint_epoch_2.pkl'
    return out


def _jax_payload(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def test_jax_checkpoint_resumes_with_every_field_equal(jax_checkpoints):
    ref = _jax_payload(jax_checkpoints['float32'])
    model = _model(scheduler=True)
    trainer = CollieTrainer(model, max_epochs=4, verbosity=0)
    assert trainer.resume_from_checkpoint(jax_checkpoints['float32']) == 2
    specs = model.optimizer_specs()
    inits = tuple(s.transform.init({k: model.params[k] for k in s.keys}) for s in specs)
    params, states, schedulers = trainer._restore(model, trainer._pending_resume, inits,
                                                  [ReduceLROnPlateau(), ReduceLROnPlateau()])
    for k, v in ref['params'].items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    for jax_state, state in zip(ref['opt_states'], states):
        assert state.count == int(jax_state.count)
        assert state.learning_rate == float(jax_state.hyperparams['learning_rate'])
        adam = jax_state.inner_state[0]
        if not hasattr(adam, 'mu'):                      # the sgd biases
            assert state.adam_count is None and not state.mu
            continue
        assert int(state.adam_count) == int(adam.count)
        for k in adam.mu:
            np.testing.assert_array_equal(state.mu[k].numpy(), adam.mu[k])
            np.testing.assert_array_equal(state.nu[k].numpy(), adam.nu[k])
    for jax_sched, sched in zip(ref['schedulers'], schedulers):
        assert type(sched) is ReduceLROnPlateau and vars(sched) == vars(jax_sched)
    assert model.hparams['num_epochs_completed'] == ref['epoch'] == 2
    assert (trainer.global_step, trainer.best_epoch_loss) == (ref['global_step'],
                                                              ref['best_epoch_loss'])


def test_jax_checkpoint_continues_in_step_mode_as_jax_does(jax_checkpoints, monkeypatch):
    # JAX's dense adaptive form, the one the port implements
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    jax_model = _model(module='jax', scheduler=True)
    jax_trainer = JaxTrainer(jax_model, max_epochs=4, verbosity=0, seed=0, epoch_mode='step')
    jax_trainer.resume_from_checkpoint(jax_checkpoints['float32'])
    jax_trainer.fit(jax_model)
    model = _model(scheduler=True)
    trainer = CollieTrainer(model, max_epochs=4, verbosity=0, seed=0, epoch_mode='step')
    trainer.resume_from_checkpoint(jax_checkpoints['float32'])
    trainer.fit(model)
    assert trainer.global_step == jax_trainer.global_step == 2 * 6
    assert trainer.best_epoch_loss[0] == jax_trainer.best_epoch_loss[0]
    np.testing.assert_allclose(trainer.best_epoch_loss[1], jax_trainer.best_epoch_loss[1],
                               rtol=1e-4)
    for k, ref in _params(jax_model).items():
        np.testing.assert_allclose(_params(model)[k], ref,
                                   atol=5e-4 * max(np.abs(ref).max(), 1e-3), rtol=0)


def test_jax_bfloat16_checkpoint_loads_through_its_bits(jax_checkpoints):
    ref = _jax_payload(jax_checkpoints['bfloat16'])
    model = _model(embeddings_dtype='bfloat16', weight_decay=1e-3)
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0)
    trainer.resume_from_checkpoint(jax_checkpoints['bfloat16'])
    trainer.fit(model)                      # restores and runs no epoch
    table = model.params['user_embeddings']
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(table.view(torch.int16).numpy().view(np.uint16),
                                  ref['params']['user_embeddings'].view(np.uint16))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_jax_checkpoint_loads_with_jax_blocked(jax_checkpoints, dtype):
    path = jax_checkpoints[dtype]
    script = (
        'import sys\n'
        "for name in ('jax', 'jaxlib', 'optax', 'ml_dtypes', 'collie_tpu'):\n"
        '    sys.modules[name] = None\n'
        'from collie_tpu_torch import optimizer_state_from_jax, read_checkpoint\n'
        f'ckpt = read_checkpoint({str(path)!r})\n'
        "state = optimizer_state_from_jax(ckpt['opt_states'][0], 'cpu')\n"
        "print(ckpt['epoch'], state.learning_rate, float(state.mu['user_embeddings'].sum()))\n")
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ref = _jax_payload(path)
    adam = ref['opt_states'][0].inner_state[-2]
    epoch, lr, mu_sum = proc.stdout.split()
    assert int(epoch) == 2
    assert float(lr) == float(ref['opt_states'][0].hyperparams['learning_rate'])
    assert float(mu_sum) == float(torch.from_numpy(adam.mu['user_embeddings']).sum())


@pytest.mark.parametrize('payload', [{'x': os.getcwd}, {'x': JaxTrainer},
                                     {'x': np.random.default_rng}])
def test_a_pickle_naming_another_global_is_refused(tmp_path, payload):
    path = tmp_path / 'checkpoint_epoch_1.pkl'
    with open(path, 'wb') as f:
        pickle.dump(payload, f)
    with pytest.raises(pickle.UnpicklingError, match='may not name the global'):
        read_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError):
        CollieTrainer(max_epochs=1).resume_from_checkpoint(path)

