"""``ApproximateNegativeSamplingInteractionsDataLoader`` in the port against
collie_tpu's, on the CPU.

The loader rejects explicit data with JAX's ``ValueError`` and switches the
``Interactions`` it is given to approximate sampling in place.  An engine
epoch over it, given JAX's ``randint`` draws through the patched
``draw_epoch``, holds exactly JAX's draws as its negatives and trains as
JAX's does, at the tolerance of ``tests/test_torch_training.py`` (params
within ``5e-4 * max|param|``, loss within rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collie_tpu.data import ApproximateNegativeSamplingInteractionsDataLoader as JaxApprox
from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (ApproximateNegativeSamplingInteractionsDataLoader,
                              CollieTrainer, ExplicitInteractions, Interactions,
                              InteractionsDataLoader, MatrixFactorizationModel, params_from_jax)
from collie_tpu_torch.training import scan_engine

from tests.test_torch_samplers_csr import jax_draws


def _kw(seed=0):
    rng = np.random.default_rng(seed)
    return dict(users=rng.integers(0, 80, 2000), items=rng.integers(0, 150, 2000),
                num_users=80, num_items=150, allow_missing_ids=True, num_negative_samples=3,
                seed=0, check_num_negative_samples_is_valid=False)


def test_explicit_data_is_rejected():
    ratings = ExplicitInteractions(users=[0, 1, 2], items=[0, 1, 2], ratings=[1, 2, 3])
    with pytest.raises(ValueError, match='does not support explicit data'):
        ApproximateNegativeSamplingInteractionsDataLoader(ratings)


def test_the_shared_interactions_are_switched_in_place():
    inter = Interactions(**_kw())
    exact = InteractionsDataLoader(inter)
    assert inter.exact_negative_sampling and not exact.approximate_negative_sampling
    loader = ApproximateNegativeSamplingInteractionsDataLoader(inter, batch_size=100)
    assert loader.interactions is inter
    assert inter.max_number_of_samples_to_consider == 0
    assert not inter.exact_negative_sampling and loader.approximate_negative_sampling
    built = ApproximateNegativeSamplingInteractionsDataLoader(**_kw())
    assert not built.interactions.exact_negative_sampling


def test_engine_epoch_equals_jax_given_its_randint_draws(monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_draws)
    common = dict(embedding_dim=4, lr=1e-1, loss='adaptive', seed=0)
    loader_kw = dict(batch_size=500, shuffle=True, seed=0)
    jax_model = JaxMF(train=JaxApprox(JaxInteractions(**_kw()), **loader_kw), **common)
    model = MatrixFactorizationModel(
        train=ApproximateNegativeSamplingInteractionsDataLoader(Interactions(**_kw()),
                                                                **loader_kw),
        map_location='cpu', **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    fn, data, S, _ = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], model.train_loader, shuffle=True)
    assert fn.sampler is None and 'indptr' not in data and 'bucket_specs' not in data
    negs = fn.epoch_batches(0, 1)['neg_items']
    sample_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 1), 3)[1]
    ref = jax.random.randint(sample_rng, (S * 500, 3), 0, 150, dtype=jnp.int32)
    np.testing.assert_array_equal(negs.reshape(-1, 3).numpy(), np.asarray(ref))

    losses = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        trainer = trainer_cls(m, max_epochs=1, verbosity=0, seed=0)
        trainer.fit(m)
        losses[name] = trainer.best_epoch_loss[1]
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-4)
    for k, ref in jax_model.params.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(model.params[k].numpy(), ref,
                                   atol=5e-4 * max(np.abs(ref).max(), 1e-3), rtol=0)
