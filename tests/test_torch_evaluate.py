"""The port's evaluation and ranking metrics against collie_tpu's: MAP@10,
MRR and AUC equal to 1e-6 with the same params, ties included, and the
column-blocked rank counts equal to the unblocked ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collie_tpu.ops.metrics as jax_metrics
from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu.evaluate import evaluate_in_batches as jax_evaluate
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
import collie_tpu_torch.ops.metrics as metrics
from collie_tpu_torch import (MatrixFactorizationModel, evaluate_in_batches, params_from_jax,
                              stratified_split)
from collie_tpu_torch.data.synthetic import generate_implicit_interactions

DATA = dict(num_users=70, num_items=260, num_interactions=4000, seed=5)


@pytest.fixture(scope='module')
def splits():
    jax_sets = jax_split(jax_generate(**DATA), test_p=0.25, seed=2, force_split=True)
    sets = stratified_split(generate_implicit_interactions(**DATA), test_p=0.25, seed=2,
                            force_split=True)
    return jax_sets, sets


def _pair(splits, params):
    jax_model = JaxMF(train=splits[0][0], embedding_dim=6, seed=0)
    jax_model.params = {k: jnp.asarray(v) for k, v in params(jax_model.params).items()}
    model = MatrixFactorizationModel(train=splits[1][0], embedding_dim=6, seed=0,
                                     map_location='cpu')
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()}, 'cpu'))
    return jax_model, model


def _random_params(seed):
    def make(params):
        rng = np.random.default_rng(seed)
        return {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in params.items()}
    return make


def _zero_params(params):
    return {k: np.zeros(np.shape(v), np.float32) for k, v in params.items()}


@pytest.mark.parametrize('params,batch_size', [
    (_random_params(0), 128),
    (_random_params(1), 16),
    (_zero_params, 32),          # all scores tie: eq_after decides every rank
])
def test_evaluate_in_batches_matches(splits, params, batch_size):
    jax_model, model = _pair(splits, params)
    expected = jax_evaluate([jax_metrics.mapk, jax_metrics.mrr, jax_metrics.auc],
                            splits[0][1], jax_model, k=10, batch_size=batch_size)
    got = evaluate_in_batches([metrics.mapk, metrics.mrr, metrics.auc], splits[1][1], model,
                              k=10, batch_size=batch_size)
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_custom_metric_path_matches(splits):
    """Custom callables take the per-batch path with numpy preds in both."""
    jax_model, model = _pair(splits, _random_params(2))

    def top1_hit(targets, user_ids, preds, k):
        best = np.argmax(preds, axis=1)
        return float(np.mean([targets[u, b] > 0 for u, b in zip(user_ids, best)]))

    expected = jax_evaluate([top1_hit, jax_metrics.mapk], splits[0][1], jax_model,
                            batch_size=24)
    got = evaluate_in_batches([top1_hit, metrics.mapk], splits[1][1], model, batch_size=24)
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_evaluate_logs_metrics(splits):
    _, model = _pair(splits, _random_params(3))
    logged = {}

    class Logger:
        def log_metrics(self, metrics, step):
            logged.update(metrics=metrics, step=step)

    value = evaluate_in_batches([metrics.mrr], splits[1][1], model, logger=Logger(),
                                verbose=False)
    assert logged == {'metrics': {'mrr': value}, 'step': 0}


def test_evaluate_rejects_explicit_data(splits):
    from collie_tpu_torch.data import ExplicitInteractions

    _, model = _pair(splits, _random_params(0))
    explicit = ExplicitInteractions(users=[0, 1], items=[0, 1], ratings=[1.0, 2.0])
    with pytest.raises(ValueError, match='must be of type ``Interactions``'):
        evaluate_in_batches([metrics.mapk], explicit, model)


def _score_block(seed, B=6, T=50, ties=False):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((B, T)).astype(np.float32)
    if ties:
        scores = np.round(scores).astype(np.float32)
    pos = np.stack([rng.choice(T, 4, replace=False) for _ in range(B)]).astype(np.int32)
    mask = np.ones((B, 4), np.float32)
    mask[0, 2:] = 0
    return scores, pos, mask


@pytest.mark.parametrize('ties', [False, True])
def test_rank_counts_match_jax_with_offsets(ties):
    scores, pos, _ = _score_block(7, ties=ties)
    pos_scores = np.array(jax_metrics.positive_scores_in_block(jnp.asarray(scores),
                                                                jnp.asarray(pos)))
    for offset, width in ((0, 50), (10, 17), (45, 5)):
        block = np.ascontiguousarray(scores[:, offset:offset + width])
        expected = jax_metrics.rank_counts_in_block(jnp.asarray(block), jnp.asarray(pos_scores),
                                                    jnp.asarray(pos), offset)
        got = metrics.rank_counts_in_block(torch.from_numpy(block),
                                           torch.from_numpy(pos_scores),
                                           torch.from_numpy(pos), offset)
        for e, g in zip(expected, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_array_equal(
            metrics.positive_scores_in_block(torch.from_numpy(block), torch.from_numpy(pos),
                                             offset).numpy(),
            np.asarray(jax_metrics.positive_scores_in_block(jnp.asarray(block),
                                                            jnp.asarray(pos), offset)))


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('block_elements', [1, 24, 100, 1 << 30])
def test_column_blocked_rank_counts_equal_unblocked(ties, block_elements):
    scores, pos, mask = _score_block(3, ties=ties)
    args = (torch.from_numpy(scores), torch.from_numpy(pos), torch.from_numpy(mask), 10)
    blocked = metrics.metrics_from_positive_ranks(*args, block_elements=block_elements)
    expected = np.asarray(jax_metrics.metrics_from_positive_ranks(
        jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(mask), 10))
    assert torch.equal(blocked, metrics.metrics_from_positive_ranks(*args))
    np.testing.assert_allclose(blocked.numpy(), expected, atol=1e-6)


@pytest.mark.parametrize('name', ['mapk', 'mrr', 'auc'])
@pytest.mark.parametrize('ties', [False, True])
def test_host_metric_wrappers_match(splits, name, ties):
    targets = splits[0][1].mat.tocsr()
    users = np.unique(splits[0][1].mat.row)[:20]
    rng = np.random.default_rng(4)
    preds = rng.standard_normal((len(users), DATA['num_items'])).astype(np.float32)
    if ties:
        preds = np.round(preds * 2).astype(np.float32)
    expected = getattr(jax_metrics, name)(targets, users, preds, k=10)
    got = getattr(metrics, name)(targets, users, preds, k=10)
    assert abs(got - expected) <= 1e-6


def test_padded_positives_equal(splits):
    targets = splits[0][1].mat.tocsr()
    users = np.arange(0, 70, 3)
    for max_degree in (None, 2):
        for a, b in zip(jax_metrics.padded_positives(targets, users, max_degree),
                        metrics.padded_positives(targets, users, max_degree)):
            np.testing.assert_array_equal(a, b)
