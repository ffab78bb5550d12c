"""Custom optimizer factories in the port (``build_transform(callable, lr,
wd)``) against collie_tpu's, on the CPU.

The factory is called as JAX calls it (``learning_rate`` and
``weight_decay``, or ``learning_rate`` alone when that raises
``TypeError``) and returns an object with the port's ``Transform``
contract.  A fit with a momentum-SGD factory must match JAX's fit with
``optax.sgd(lr, momentum=0.9)`` on JAX's epoch draws at the tolerance of
``tests/test_torch_training.py`` (params within ``5e-4 * max|param|``,
epoch losses within rtol 1e-4); such a model never takes the fused epoch.
"""
import numpy as np
import optax
import pytest
import torch

from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.schedulers import StepLR as JaxStepLR
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieTrainer, Interactions, MatrixFactorizationModel, StepLR,
                              params_from_jax)
from collie_tpu_torch.training import scan_engine
from collie_tpu_torch.training.optimizers import build_transform, get_lr, set_lr

from tests.test_torch_samplers_csr import jax_draws


class MomentumSGD:
    """optax.sgd(learning_rate, momentum) as a port transform: the trace
    ``g + momentum * trace``, then ``-learning_rate * trace``."""

    def __init__(self, learning_rate, momentum=0.9):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, state, params):
        trace = {k: grads[k] + self.momentum * state[k] for k in grads}
        return {k: -self.learning_rate * t for k, t in trace.items()}, trace


def test_factory_gets_learning_rate_and_weight_decay_or_learning_rate_alone():
    calls = []

    def both(learning_rate, weight_decay):
        calls.append(('both', learning_rate, weight_decay))
        return MomentumSGD(learning_rate)

    def lr_only(learning_rate):
        calls.append(('lr_only', learning_rate))
        return MomentumSGD(learning_rate)

    build_transform(both, 0.5, 0.01)
    build_transform(lr_only, 0.25, 0.01)
    assert calls == [('both', 0.5, 0.01), ('lr_only', 0.25)]


def test_bfloat16_params_get_float32_state_and_bfloat16_updates():
    transform = build_transform(lambda learning_rate: MomentumSGD(learning_rate), 0.1)
    params = {'emb': torch.ones(4, 2, dtype=torch.bfloat16), 'bias': torch.ones(4)}
    state = transform.init(params)
    assert {k: v.dtype for k, v in state.items()} == {'emb': torch.float32,
                                                      'bias': torch.float32}
    grads = {'emb': torch.full((4, 2), 0.3, dtype=torch.bfloat16), 'bias': torch.ones(4)}
    updates, state = transform.update(grads, state, params)
    assert updates['emb'].dtype == torch.bfloat16 and state['emb'].dtype == torch.float32
    assert torch.equal(state['emb'], torch.full((4, 2), float(torch.tensor(0.3).bfloat16())))


def _pair(factory_pair, scheduler=None):
    rng = np.random.default_rng(0)
    kw = dict(users=rng.integers(0, 80, 2000), items=rng.integers(0, 150, 2000),
              num_users=80, num_items=150, allow_missing_ids=True, num_negative_samples=3,
              seed=0, check_num_negative_samples_is_valid=False)
    jax_sched = sched = None
    if scheduler is not None:
        jax_sched, sched = JaxStepLR(*scheduler), StepLR(*scheduler)
    common = dict(embedding_dim=4, lr=1.0, loss='adaptive', seed=0)
    jax_model = JaxMF(train=JaxInteractions(**kw), optimizer=factory_pair[0],
                      lr_scheduler_func=jax_sched, **common)
    model = MatrixFactorizationModel(train=Interactions(**kw), optimizer=factory_pair[1],
                                     lr_scheduler_func=sched, map_location='cpu', **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    return jax_model, model


MOMENTUM = (lambda learning_rate: optax.sgd(learning_rate, momentum=0.9),
            lambda learning_rate: MomentumSGD(learning_rate))


def test_momentum_factory_fit_matches_optax_sgd(monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_draws)
    jax_model, model = _pair(MOMENTUM)
    fused = []
    build = scan_engine.build_scan_epoch_fns

    def recording(*args, **kwargs):
        out = build(*args, **kwargs)
        fused.append(out[0].fused)
        return out

    monkeypatch.setattr('collie_tpu_torch.training.trainer.build_scan_epoch_fns', recording)
    losses = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        log = []
        trainer_cls(m, max_epochs=2, verbosity=0, seed=0,
                    logger=type('L', (), {'log_metrics': lambda self, x, step: log.append(x)})()
                    ).fit(m)
        losses[name] = [x['train_loss_epoch'] for x in log]
    assert fused == [False]
    assert scan_engine._fused_epoch_config(model, model.optimizer_specs(), [True, True],
                                           model.train_loader) is None
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-4)
    assert losses['port'][1] < losses['port'][0]
    for k, ref in jax_model.params.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(model.params[k].numpy(), ref,
                                   atol=5e-4 * max(np.abs(ref).max(), 1e-3), rtol=0)


def test_a_scheduler_firing_on_a_state_without_learning_rate_raises(monkeypatch):
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_draws)
    jax_model, model = _pair(MOMENTUM, scheduler=(1, 0.5))
    message = 'Optimizer state carries no injected hyperparams'
    for trainer_cls, m in ((JaxTrainer, jax_model), (CollieTrainer, model)):
        with pytest.raises(ValueError, match=message):
            trainer_cls(m, max_epochs=2, verbosity=0, seed=0).fit(m)
        assert m.hparams['num_epochs_completed'] == 1
    state = build_transform(MOMENTUM[1], 0.1).init({'w': torch.ones(2)})
    for call in (lambda: get_lr(state), lambda: set_lr(state, 0.1)):
        with pytest.raises(ValueError, match=message):
            call()
