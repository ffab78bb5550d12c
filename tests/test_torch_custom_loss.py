"""Custom losses that do not take ``sample_weights``, in the port against
collie_tpu.

collie_tpu calls a loss through ``_call_loss``
(``collie_tpu/models/base.py:899-906``): on a ``TypeError`` it calls again
without ``sample_weights``, at the implicit call and at the explicit one.
The port does the same.  Each test fits one such model in both packages
from the same params on JAX's epoch draws for 2 epochs, at the tolerances
of ``tests/test_torch_training.py`` (params within ``5e-4 * max|param|``,
per-epoch losses within rtol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel, params_from_jax
from collie_tpu_torch.training import scan_engine

from tests import test_torch_explicit_training as explicit
from tests import test_torch_training as implicit

EPOCHS = 2


def implicit_loss_without_weights(xp):
    """A pairwise hinge taking every keyword of the implicit call but
    ``sample_weights``; ``xp`` is ``jnp`` or ``torch``."""
    def loss(pos_preds, neg_preds, num_items=None, positive_items=None, negative_items=None,
             metadata=None, metadata_weights=None):
        gap = 1.0 - (pos_preds - neg_preds)
        return xp.mean(gap * (gap > 0))
    return loss


def ratings_only_loss(preds, ratings):
    """Squared error over ``(preds, ratings)`` alone; operators only, so
    one function serves both packages."""
    return ((preds - ratings) ** 2).mean()


def _fit_both(jax_train, train, draws, monkeypatch, jax_loss, loss, **common):
    monkeypatch.setattr(scan_engine, 'draw_epoch', draws)
    jax_model = JaxMF(train=jax_train, loss=jax_loss, **common)
    model = MatrixFactorizationModel(train=train, loss=loss, map_location='cpu', **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    out = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        recorder = implicit.Recorder()
        trainer_cls(m, max_epochs=EPOCHS, verbosity=0, seed=0, logger=recorder,
                    enable_model_summary=False).fit(m)
        out[name] = {'losses': [metrics['train_loss_epoch'] for _, metrics in recorder.metrics
                                if 'train_loss_epoch' in metrics],
                     'params': {k: np.asarray(v.float() if torch.is_tensor(v) else v)
                                for k, v in m.params.items()}}
    ref, port = out['jax'], out['port']
    assert len(port['losses']) == len(ref['losses']) == EPOCHS
    assert np.isfinite(port['losses']).all()
    assert port['losses'][-1] < port['losses'][0]
    np.testing.assert_allclose(port['losses'], ref['losses'], rtol=1e-4)
    implicit._assert_params_close(ref['params'], port['params'])


def test_implicit_loss_without_sample_weights_fits_like_jax(monkeypatch):
    jax_train, _ = implicit.jax_split(implicit.jax_generate(**implicit.DATA), test_p=0.2, seed=1,
                                      force_split=True)
    train, _ = implicit.stratified_split(implicit.generate_implicit_interactions(**implicit.DATA),
                                         test_p=0.2, seed=1, force_split=True)
    _fit_both(jax_train, train, implicit.jax_epoch_draws, monkeypatch,
              implicit_loss_without_weights(jnp), implicit_loss_without_weights(torch),
              embedding_dim=8, lr=1e-1, seed=0)


def test_explicit_loss_of_preds_and_ratings_fits_like_jax(monkeypatch):
    jax_train, _ = explicit.jax_split(
        explicit._explicit(explicit.JaxExplicit, explicit.jax_generate(**explicit.DATA)),
        test_p=0.2, seed=1, force_split=True)
    train, _ = explicit.stratified_split(
        explicit._explicit(explicit.ExplicitInteractions,
                           explicit.generate_interactions_df(**explicit.DATA)),
        test_p=0.2, seed=1, force_split=True)
    _fit_both(jax_train, train, explicit.jax_explicit_draws, monkeypatch,
              ratings_only_loss, ratings_only_loss, embedding_dim=8, lr=1e-2, seed=0)


def test_a_loss_that_takes_sample_weights_gets_them():
    """The retry is only for a ``TypeError``: a loss that takes
    ``sample_weights`` is called once, with the batch's mask."""
    from collie_tpu_torch.models.base import _call_loss

    calls = []

    def loss(preds, ratings, sample_weights=None):
        calls.append(sample_weights)
        return preds.sum()

    mask = torch.tensor([1.0, 0.0])
    _call_loss(loss, torch.ones(2), torch.ones(2), sample_weights=mask)
    assert len(calls) == 1 and calls[0] is mask
    with pytest.raises(TypeError):
        _call_loss(lambda preds: preds, torch.ones(2), torch.ones(2), sample_weights=mask)
