"""The port's ``recommend`` against collie_tpu's on every path.

The path is chosen by ``COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB`` in both
packages: 512 MiB keeps these small catalogs on the dense path, 0 sends
``filter_seen=False`` through the kernel gate (the Pallas kernel in interpret
mode in JAX, the kernel module's plain version on the CPU here) and
``filter_seen=True`` through the blockwise path.  Ids must be equal, ties
and sentinel fills included; scores within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collie_tpu.data as jdata
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.ops.device_sampling import pairs_in_csr as jax_pairs_in_csr
from collie_tpu.retrieval import build_retrieval_fn as jax_build_retrieval_fn
from collie_tpu.retrieval import recommend as jax_recommend
import collie_tpu_torch.data as tdata
import collie_tpu_torch.retrieval as retrieval
from collie_tpu_torch import MatrixFactorizationModel, params_from_jax, recommend
from collie_tpu_torch.ops.device_sampling import pairs_in_csr

NUM_USERS, NUM_ITEMS = 40, 300


def _interactions(data, seed=0, heavy_user=False):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, NUM_USERS, 2500)
    items = rng.integers(0, NUM_ITEMS, 2500)
    if heavy_user:   # user 0 has seen all but <= 6 items: fewer than k survive
        users = np.concatenate([users, np.zeros(NUM_ITEMS - 6, np.int64)])
        items = np.concatenate([items, np.arange(6, NUM_ITEMS)])
    return data.Interactions(users=users, items=items, num_users=NUM_USERS,
                             num_items=NUM_ITEMS, allow_missing_ids=True,
                             num_negative_samples=1,
                             check_num_negative_samples_is_valid=False, seed=seed)


def _pair(seed=0, heavy_user=False, ties=False, with_val=False, **kwargs):
    rng = np.random.default_rng(seed)
    models = []
    for data, cls, extra in ((jdata, JaxMF, {}),
                             (tdata, MatrixFactorizationModel, {'map_location': 'cpu'})):
        train = _interactions(data, seed, heavy_user)
        val = _interactions(data, seed + 100) if with_val else None
        models.append(cls(train=train, val=val, embedding_dim=8, seed=0, **extra, **kwargs))
    jax_model, model = models
    params = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
              for k, v in jax_model.params.items()}
    if ties:   # duplicated items on a coarse grid tie exactly
        for name in ('item_embeddings', 'item_biases'):
            params[name] = np.round(params[name])
            params[name][150:] = params[name][:150]
        for name in ('user_embeddings', 'user_biases'):
            params[name] = np.round(params[name])
    jax_model.params = {k: jnp.asarray(v).astype(jax_model.params[k].dtype)
                        for k, v in params.items()}
    model.load_params(params_from_jax(params, 'cpu'))
    return jax_model, model


def _assert_same(jax_out, out):
    np.testing.assert_array_equal(out[0], jax_out[0])
    np.testing.assert_allclose(out[1], jax_out[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('budget', ['512', '0'])
@pytest.mark.parametrize('filter_seen', [False, True])
@pytest.mark.parametrize('ties', [False, True])
def test_recommend_matches_jax(monkeypatch, budget, filter_seen, ties):
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', budget)
    jax_model, model = _pair(seed=1, ties=ties)
    users = np.array([0, 3, 7, 11, 39, 3])
    kwargs = dict(k=10, filter_seen=filter_seen, item_tile=64)
    _assert_same(jax_recommend(jax_model, users, **kwargs), recommend(model, users, **kwargs))


@pytest.mark.parametrize('budget', ['512', '0'])
def test_fewer_than_k_unseen_items_fill_like_jax(monkeypatch, budget):
    """User 0 has at most 6 unseen items and k=10: the sentinel-scored fill ids must
    be the JAX package's (lowest masked ids on the dense path, the running
    top-k's initial ids on the blockwise one)."""
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', budget)
    jax_model, model = _pair(seed=2, heavy_user=True)
    users = np.array([0, 1])
    kwargs = dict(k=10, filter_seen=True, item_tile=32)
    jax_ids, jax_scores = jax_recommend(jax_model, users, **kwargs)
    ids, scores = recommend(model, users, **kwargs)
    np.testing.assert_array_equal(ids, jax_ids)
    unseen = set(range(NUM_ITEMS)) - set(model.train_loader.mat.tocsr()[0].indices)
    assert 0 < len(unseen) < 10
    assert set(ids[0, :len(unseen)]) == unseen
    np.testing.assert_array_equal(scores[0, len(unseen):], jax_scores[0, len(unseen):])


def test_val_interactions_are_filtered_too(monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', '0')
    jax_model, model = _pair(seed=3, with_val=True)
    users = np.arange(0, 40, 5)
    ids, _ = recommend(model, users, k=8, filter_seen=True, item_tile=100)
    _assert_same(jax_recommend(jax_model, users, k=8, filter_seen=True, item_tile=100),
                 (ids, _))
    seen = (model.train_loader.mat.tocsr() + model.val_loader.mat.tocsr()).tocsr()
    for row, u in zip(ids, users):
        assert not set(row) & set(seen[u].indices)


@pytest.mark.parametrize('budget', ['512', '0'])
def test_y_range_matches_jax(monkeypatch, budget):
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', budget)
    jax_model, model = _pair(seed=4, y_range=(1.0, 5.0))
    users = np.array([2, 9])
    _assert_same(jax_recommend(jax_model, users, k=5, filter_seen=False, item_tile=128),
                 recommend(model, users, k=5, filter_seen=False, item_tile=128))


@pytest.mark.parametrize('budget,filter_seen,k,kernel_calls', [
    ('512', False, 10, 0),     # dense block fits
    ('0', False, 10, 1),       # over budget: the kernel
    ('0', True, 10, 0),        # seen filtering: blockwise
    ('0', False, 129, 0),      # k above the kernel's limit: blockwise
])
def test_path_selection(monkeypatch, budget, filter_seen, k, kernel_calls):
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', budget)
    calls = []
    original = retrieval.mf_topk_retrieve
    monkeypatch.setattr(retrieval, 'mf_topk_retrieve',
                        lambda *a, **kw: calls.append(kw) or original(*a, **kw))
    _, model = _pair(seed=5)
    ids, _ = recommend(model, [1, 2, 3], k=k, filter_seen=filter_seen, item_tile=64)
    assert len(calls) == kernel_calls and ids.shape == (3, k)
    if kernel_calls:
        assert calls[0] == {'k': k, 'tile': 64}


def test_bfloat16_tables_skip_the_kernel(monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', '0')
    monkeypatch.setattr(retrieval, 'mf_topk_retrieve', None)
    jax_model, model = _pair(seed=6, embeddings_dtype='bfloat16')
    users = np.array([4, 5])
    _assert_same(jax_recommend(jax_model, users, k=6, filter_seen=False, item_tile=50),
                 recommend(model, users, k=6, filter_seen=False, item_tile=50))


def test_seen_set_follows_the_loaders():
    _, model = _pair(seed=7)
    before, _ = recommend(model, [5], k=10, filter_seen=True)
    model.train_loader = tdata.InteractionsDataLoader(
        tdata.Interactions(users=[5] * 10, items=before[0], num_users=NUM_USERS,
                           num_items=NUM_ITEMS, allow_missing_ids=True,
                           num_negative_samples=1))
    after, _ = recommend(model, [5], k=10, filter_seen=True)
    assert not set(after[0]) & set(before[0])


def test_k_exceeding_catalog_raises_like_jax():
    jax_model, model = _pair(seed=8)
    with pytest.raises(ValueError) as jax_err:
        jax_recommend(jax_model, [0], k=NUM_ITEMS + 1)
    with pytest.raises(ValueError) as err:
        recommend(model, [0], k=NUM_ITEMS + 1)
    assert str(err.value) == str(jax_err.value)


def test_filter_seen_requires_seen_arrays():
    jax_model, model = _pair(seed=9)
    with pytest.raises(ValueError) as jax_err:
        jax_build_retrieval_fn(jax_model, k=5, filter_seen=True)(jax_model.params, np.arange(4))
    with pytest.raises(ValueError) as err:
        retrieval.build_retrieval_fn(model, k=5, filter_seen=True)(
            model.params, torch.arange(4))
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize('seed', [0, 1])
def test_pairs_in_csr_matches_jax(seed):
    from scipy.sparse import random as sparse_random

    csr = sparse_random(30, 200, density=0.1, format='csr', random_state=seed)
    csr.sort_indices()
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 30, (12, 1))
    items = np.concatenate([rng.integers(0, 200, 40), csr.indices[:20], [199, 250]])[None, :]
    expected = np.asarray(jax_pairs_in_csr(jnp.asarray(csr.indptr, jnp.int32),
                                           jnp.asarray(csr.indices, jnp.int32),
                                           jnp.asarray(users, jnp.int32),
                                           jnp.asarray(items, jnp.int32)))
    got = pairs_in_csr(torch.as_tensor(csr.indptr), torch.as_tensor(csr.indices),
                       torch.as_tensor(users), torch.as_tensor(items))
    assert got.shape == (12, items.shape[1]) and expected.any()
    np.testing.assert_array_equal(got.numpy(), expected)


def test_pairs_in_empty_csr_is_all_false():
    got = pairs_in_csr(torch.zeros(4, dtype=torch.int64), torch.zeros(0, dtype=torch.int64),
                       torch.tensor([0, 1, 2]), torch.tensor([5, 6, 7]))
    assert not got.any() and got.shape == (3,)
