"""The zoo's training epoch: the port's generic autograd epoch against the
JAX engine's, and dropout in the port's epoch.

Models and params as in ``tests/test_torch_zoo.py``.  Without dropout both
packages fit one epoch on JAX's epoch draws (``draw_epoch`` patched as in
``tests/test_torch_training.py``), JAX on its dense branch
(``COLLIE_TPU_SPARSE_ADAPTIVE=0``).  The epoch loss must agree within rtol
1e-4, and the params within ``5e-4 * max|param|`` (the tolerance of
``tests/test_torch_training.py``: the engines sum duplicate-row gradients in
different orders and Adam amplifies the difference).  With dropout the
port's epoch is held to its own contract: one generator per step, seeded by
``dropout_step_seeds``, so a fit is reproducible from its seed (within
1e-6: the CPU's threads may sum duplicate rows' gradients in another
order).
"""
import numpy as np
import pytest

from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import CollieTrainer
from collie_tpu_torch.training import scan_engine

from tests.test_torch_training import jax_epoch_draws
from tests.test_torch_zoo import VARIANTS, build_pair, data  # noqa: F401

ZOO = ['mlp_mf', 'nonlinear_mf', 'neucf', 'deep_fm', 'cml']
NO_DROPOUT = dict(dropout_p=0.0, dense_dropout_p=0.0, embedding_dropout_p=0.0)


def _without_dropout(variant):
    return {k: v for k, v in NO_DROPOUT.items() if k in VARIANTS[variant][1]}


@pytest.mark.parametrize('variant', ZOO)
def test_generic_epoch_matches_jax(variant, data, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    jax_model, model = build_pair(variant, data, **_without_dropout(variant))
    losses = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        trainer = trainer_cls(m, max_epochs=1, verbosity=0, seed=0)
        trainer.fit(m)
        losses[name] = trainer.best_epoch_loss
    assert losses['port'][0] == losses['jax'][0] == 1
    np.testing.assert_allclose(losses['port'][1], losses['jax'][1], rtol=1e-4)
    for k, ref in jax_model.params.items():
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(model.params[k].numpy(), ref, atol=5e-4 * scale, rtol=0,
                                   err_msg=f'param {k} diverged')


@pytest.mark.parametrize('variant', ['mf_dropout', 'mlp_mf', 'nonlinear_mf', 'neucf',
                                     'deep_fm'])
def test_fit_with_dropout_draws_one_stream_per_step(variant, data, monkeypatch):
    seeds = []
    calculate_loss = type(build_pair(variant, data)[1]).calculate_loss

    def recording(self, params, batch, generator=None, training=True):
        seeds.append(generator.initial_seed())
        return calculate_loss(self, params, batch, generator=generator, training=training)

    fits = []
    for seed in (0, 0, 1):
        _, model = build_pair(variant, data)
        monkeypatch.setattr(type(model), 'calculate_loss', recording)
        seeds.clear()
        trainer = CollieTrainer(model, max_epochs=2, verbosity=0, seed=seed)
        trainer.fit(model)
        assert np.isfinite(trainer.best_epoch_loss[1])
        S = len(seeds) // 2
        assert seeds == (scan_engine.dropout_step_seeds(seed, 1, S)
                         + scan_engine.dropout_step_seeds(seed, 2, S))
        fits.append({k: v.clone() for k, v in model.params.items()})
    # the same seed gives the same fit (up to the order in which the CPU's
    # threads sum duplicate rows' gradients); another seed gives another
    assert max(float((fits[0][k] - fits[1][k]).abs().max()) for k in fits[0]) < 1e-6
    assert max(float((fits[0][k] - fits[2][k]).abs().max()) for k in fits[0]) > 1e-3
