"""The trainer's per-step path (``epoch_mode='step'``, custom loaders,
``PrefetchLoader``) against collie_tpu's on the CPU.

Both packages read their batches from the same numpy loader code with the
same seed, so they train on identical batches.  Per-step fits, implicit and
explicit, with per-step validation, must match JAX's at the tolerance of
``tests/test_torch_training.py``: params within ``5e-4 * max|param|`` (the
engines sum duplicate-row gradients in different orders and Adam amplifies
the difference), epoch and step losses within rtol 1e-4.  A dropout model
runs on JAX's masks (``MaskTape``, JAX run eagerly so every step draws
anew), replayed in global-step order.  Fits of the port against itself
(a custom iterable loader, ``PrefetchLoader``) must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from collie_tpu.data import ExplicitInteractions as JaxExplicit
from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.data import InteractionsDataLoader as JaxLoader
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieMinimalTrainer, CollieTrainer, ExplicitInteractions,
                              Interactions, InteractionsDataLoader, MatrixFactorizationModel,
                              PrefetchLoader, params_from_jax)

from tests.test_torch_dropout import MaskTape

NUM_USERS, NUM_ITEMS, N = 60, 120, 1500


class Recorder:
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))

    def values(self, key):
        return [(s, m[key]) for s, m in self.metrics if key in m]


def _data(explicit, seed):
    rng = np.random.default_rng(seed)
    kw = dict(users=rng.integers(0, NUM_USERS, N), items=rng.integers(0, NUM_ITEMS, N),
              num_users=NUM_USERS, num_items=NUM_ITEMS, allow_missing_ids=True)
    if explicit:
        kw['ratings'] = rng.integers(1, 6, N).astype(np.float64)
        return kw
    return dict(kw, num_negative_samples=3, seed=0, check_num_negative_samples_is_valid=False)


def _pair(explicit=False, val=True, **model_kw):
    classes = ((JaxExplicit, ExplicitInteractions) if explicit
               else (JaxInteractions, Interactions))
    loaders = []
    for cls, loader_cls in zip(classes, (JaxLoader, InteractionsDataLoader)):
        train = loader_cls(cls(**_data(explicit, 1)), batch_size=256, shuffle=True, seed=3)
        test = loader_cls(cls(**_data(explicit, 2)), batch_size=256) if val else None
        loaders.append((train, test))
    common = dict(embedding_dim=4, lr=1e-2, seed=0,
                  loss='mse' if explicit else 'adaptive', **model_kw)
    if explicit:
        common['y_range'] = (1, 5)
    jax_model = JaxMF(train=loaders[0][0], val=loaders[0][1], **common)
    model = MatrixFactorizationModel(train=loaders[1][0], val=loaders[1][1],
                                     map_location='cpu', **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    return jax_model, model


def _params(model):
    return {k: np.asarray(v) if not torch.is_tensor(v) else v.numpy()
            for k, v in model.params.items()}


def _assert_params_close(jax_model, model):
    port = _params(model)
    for k, ref in _params(jax_model).items():
        np.testing.assert_allclose(port[k], ref, atol=5e-4 * max(np.abs(ref).max(), 1e-3),
                                   rtol=0, err_msg=f'param {k} diverged')


def _fit(model, trainer_cls, epochs=2, **kwargs):
    logger = Recorder()
    trainer = trainer_cls(model, max_epochs=epochs, verbosity=0, seed=0, logger=logger,
                          log_every_n_steps=3, **kwargs)
    trainer.fit(model)
    return trainer, logger


@pytest.mark.parametrize('explicit', [False, True])
def test_step_fit_with_validation_matches_jax(explicit, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    jax_model, model = _pair(explicit)
    jax_trainer, jax_log = _fit(jax_model, JaxTrainer, epoch_mode='step')
    trainer, log = _fit(model, CollieTrainer, epoch_mode='step')
    assert trainer.global_step == jax_trainer.global_step == 2 * 6
    for key in ('train_loss_epoch', 'val_loss_epoch', 'train_loss_step'):
        steps, values = zip(*log.values(key))
        ref_steps, ref_values = zip(*jax_log.values(key))
        assert steps == ref_steps, key
        np.testing.assert_allclose(values, ref_values, rtol=1e-4, err_msg=key)
    assert [s for s, _ in log.values('train_loss_step')] == [3, 6, 9, 12]
    _assert_params_close(jax_model, model)
    assert [e['steps'] for e in trainer.epoch_log] == [6, 6]


def test_step_fit_with_dropout_matches_jax_on_its_masks(monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setenv('COLLIE_TPU_STEP_SCAN_GROUP', '1')
    jax_model, model = _pair(val=False, dropout_p=0.3)
    tape = MaskTape(monkeypatch)
    with jax.disable_jit():
        _, jax_log = _fit(jax_model, JaxTrainer, epochs=1, epoch_mode='step')
    assert len(tape.masks) == 6 * 2 * 2          # steps x (pos, neg) x (user, item)
    _, log = _fit(model, CollieTrainer, epochs=1, epoch_mode='step')
    assert not tape.masks
    np.testing.assert_allclose([v for _, v in log.values('train_loss_step')],
                               [v for _, v in jax_log.values('train_loss_step')], rtol=1e-4)
    _assert_params_close(jax_model, model)


class PlainLoader:
    """A custom loader: any iterable of numpy batch dicts with the dataset
    attributes a model reads."""

    def __init__(self, loader):
        self.loader = loader
        self.num_users, self.num_items = loader.num_users, loader.num_items
        self.num_negative_samples = loader.num_negative_samples

    def __iter__(self):
        yield from iter(self.loader)


def _port_model(**kwargs):
    return _pair(val=False, **kwargs)[1]


def test_scan_mode_with_a_custom_loader_raises():
    model = _port_model()
    model.train_loader = PlainLoader(model.train_loader)
    with pytest.raises(ValueError, match='epoch_mode="scan" requires an in-memory'):
        CollieTrainer(model, max_epochs=1, verbosity=0, epoch_mode='scan').fit(model)


@pytest.mark.parametrize('wrap', ['plain', 'prefetch'])
def test_custom_loaders_train_through_the_step_path(wrap):
    """A plain iterable and a ``PrefetchLoader`` (``epoch_mode='auto'``)
    fit exactly as ``epoch_mode='step'`` over the bare loader."""
    ref = _port_model()
    ref_trainer, ref_log = _fit(ref, CollieTrainer, epoch_mode='step')
    model = _port_model()
    model.train_loader = (PlainLoader if wrap == 'plain' else PrefetchLoader)(
        model.train_loader)
    trainer, log = _fit(model, CollieTrainer)
    assert trainer.global_step == ref_trainer.global_step == 12
    assert log.metrics == ref_log.metrics
    for k, v in ref.params.items():
        assert torch.equal(model.params[k], v), k


def test_prefetch_loader_yields_the_bare_loaders_batches():
    bare = InteractionsDataLoader(Interactions(**_data(False, 1)), batch_size=256,
                                  shuffle=True, seed=3)
    again = InteractionsDataLoader(Interactions(**_data(False, 1)), batch_size=256,
                                   shuffle=True, seed=3)
    wrapped = PrefetchLoader(again, buffer_size=2)
    assert len(wrapped) == len(bare) == 6
    assert wrapped.num_items == NUM_ITEMS and wrapped.batch_size == 256
    for _ in range(2):                            # two epochs, each reshuffled
        for a, b in zip(bare, wrapped):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_reraises_producer_errors():
    class Exploding:
        def __iter__(self):
            yield {'users': np.zeros(2)}
            raise RuntimeError('disk went away')

    seen = []
    with pytest.raises(RuntimeError, match='disk went away'):
        for batch in PrefetchLoader(Exploding()):
            seen.append(batch)
    assert len(seen) == 1


def test_step_logging_and_global_step_as_jax(monkeypatch):
    """``train_loss_step`` every ``log_every_n_steps`` on the per-step path;
    the whole-epoch path logs epochs only and leaves ``global_step`` at 0,
    in both packages."""
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    jax_model, model = _pair(val=False)
    jax_trainer, jax_log = _fit(jax_model, JaxTrainer, epochs=1)
    trainer, log = _fit(model, CollieTrainer, epochs=1)
    assert trainer.global_step == jax_trainer.global_step == 0
    assert [s for s, _ in log.metrics] == [s for s, _ in jax_log.metrics] == [1]
    jax_trainer, jax_log = _fit(jax_model, JaxTrainer, epochs=2, epoch_mode='step')
    trainer, log = _fit(model, CollieTrainer, epochs=2, epoch_mode='step')
    assert trainer.global_step == jax_trainer.global_step == 6
    assert [(s, sorted(m)) for s, m in log.metrics] == \
        [(s, sorted(m)) for s, m in jax_log.metrics]


def test_minimal_trainer_is_the_trainer():
    assert issubclass(CollieMinimalTrainer, CollieTrainer)
    model = _port_model()
    trainer = CollieMinimalTrainer(model, max_epochs=1, verbosity=0, epoch_mode='step')
    trainer.fit(model)
    assert trainer.num_epochs_completed == 1 and trainer.global_step == 6
