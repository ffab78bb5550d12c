"""The CSR, distinct and redraw-rounds samplers of
``collie_tpu_torch.ops.device_sampling`` and the engine's sampler routing,
against collie_tpu on the CPU.

The samplers take their draws as inputs, one block per round; given JAX's
draws (``jax.random.split`` of the sampler's key, in order) they must
return JAX's negatives exactly, degenerate users included.  The port has
no padded sampler: its CSR sampler must return what JAX's padded sampler
returns too.  The engine chooses its sampler from ``COLLIE_TPU_SAMPLER``
and ``COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB`` as JAX's does, but for
``padded``, which takes the CSR sampler; an engine epoch under
``COLLIE_TPU_SAMPLER=padded`` or ``csr``, given JAX's epoch draws through
the patched ``draw_epoch``, holds exactly JAX's sampler output at its batch
positions; the epoch's training then matches JAX's at the tolerance of
``tests/test_torch_training.py`` (params within ``5e-4 * max|param|``,
loss within rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

import collie_tpu.ops.device_sampling as jax_sampling
from collie_tpu.data import Interactions as JaxInteractions
from collie_tpu.data import InteractionsDataLoader as JaxLoader
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.scan_engine import build_scan_epoch_fns as jax_build_epoch
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieTrainer, Interactions, InteractionsDataLoader,
                              MatrixFactorizationModel, params_from_jax)
from collie_tpu_torch.ops import device_sampling as sampling
from collie_tpu_torch.training import scan_engine

NUM_USERS, NUM_ITEMS = 40, 200


def jax_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items, exact):
    """The JAX engine's epoch draws, as the port's ``draw_epoch`` returns
    them: the Feistel keys, then the sampler's uniforms (a leading axis of
    rounds, split from the sampler's key as JAX's padded and CSR samplers
    split it) or, for approximate sampling, its ``randint`` item ids."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx)
    if training:
        perm_rng, sample_rng, _ = jax.random.split(rng, 3)
    else:
        perm_rng, sample_rng = jax.random.split(rng)
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    if sample_shape is None:
        return keys, None
    if not exact:
        draws = jax.random.randint(sample_rng, sample_shape, 0, num_items, dtype=jnp.int32)
    elif len(sample_shape) == 3:
        draws = jnp.stack([jax.random.uniform(k, sample_shape[1:])
                           for k in jax.random.split(sample_rng, sample_shape[0])])
    else:
        draws = jax.random.uniform(sample_rng, sample_shape)
    return keys, torch.from_numpy(np.array(draws))


@pytest.fixture(scope='module')
def problem():
    """A CSR with degree 0 to 59 and three degenerate users: user 0 holds
    every item but one, user 1 every item, user 2 every item but 3."""
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for u in range(NUM_USERS):
        d = [NUM_ITEMS - 1, NUM_ITEMS, NUM_ITEMS - 3][u] if u < 3 else rng.integers(0, 60)
        rows += [u] * d
        cols += list(rng.choice(NUM_ITEMS, d, replace=False))
    mat = csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(NUM_USERS, NUM_ITEMS))
    users = rng.integers(0, NUM_USERS, 300).astype(np.int32)
    users[:12] = np.repeat([0, 1, 2], 4)
    return mat, users


def _split_uniforms(key, rounds, shape):
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, shape))
                                      for k in jax.random.split(key, rounds)]))


@pytest.mark.parametrize('builder', ['build_complement_tables'])
def test_table_builders_are_bit_equal(problem, builder):
    mat, _ = problem
    ref = getattr(jax_sampling, builder)(mat)
    out = getattr(sampling, builder)(mat)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('dedup', [0, 1, 2])
@pytest.mark.parametrize('K', [1, 5])
@pytest.mark.parametrize('kind', ['padded', 'csr'])
def test_complement_samplers_equal_jax_given_its_draws(problem, kind, K, dedup):
    """The port's CSR sampler against JAX's ``kind`` sampler, on its draws."""
    mat, users = problem
    key = jax.random.PRNGKey(10 * K + dedup)
    indptr, shifted = jax_sampling.build_complement_tables(mat)
    if kind == 'padded':
        pad, counts = jax_sampling.build_padded_complement_table(mat)
        ref = jax_sampling.complement_sample_negatives_padded_impl(
            key, jnp.asarray(users), jnp.asarray(pad), jnp.asarray(counts), NUM_ITEMS, K,
            dedup_rounds=dedup)
    else:
        ref = jax_sampling.complement_sample_negatives(
            key, jnp.asarray(users), jnp.asarray(indptr), jnp.asarray(shifted), NUM_ITEMS, K,
            dedup_rounds=dedup)
    u01 = _split_uniforms(key, 1 + dedup, users.shape + (K,))
    out = sampling.complement_sample_negatives(u01, torch.from_numpy(users),
                                               torch.from_numpy(indptr),
                                               torch.from_numpy(shifted), NUM_ITEMS, K,
                                               dedup_rounds=dedup)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('K', [1, 5])
def test_distinct_sampler_equals_jax_given_its_draws(problem, K):
    mat, users = problem
    key = jax.random.PRNGKey(K)
    indptr, shifted = jax_sampling.build_complement_tables(mat)
    ref = jax_sampling.distinct_complement_sample_negatives(
        key, jnp.asarray(users), jnp.asarray(indptr), jnp.asarray(shifted), NUM_ITEMS, K)
    out = sampling.distinct_complement_sample_negatives(
        _split_uniforms(key, 2, users.shape + (K,)), torch.from_numpy(users),
        torch.from_numpy(indptr), torch.from_numpy(shifted), NUM_ITEMS, K)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ordinary = users >= 3
    rows = np.sort(out.numpy()[ordinary], axis=1)
    assert (np.diff(rows, axis=1) > 0).all()          # K distinct values per row


@pytest.mark.parametrize('exact', [True, False])
@pytest.mark.parametrize('K', [1, 5])
def test_rounds_sampler_equals_jax_given_its_draws(problem, K, exact):
    mat, users = problem
    coo = mat.tocoo()
    keys = np.unique(coo.row.astype(np.int32) * NUM_ITEMS + coo.col.astype(np.int32))
    users = users[12:76]
    key = jax.random.PRNGKey(3 + K)
    rounds = 8 if exact else 0
    ref = jax_sampling.sample_negatives(key, jnp.asarray(users), jnp.asarray(keys), NUM_ITEMS,
                                        K, exact=exact, max_resample_rounds=8)
    rng, draw_key = jax.random.split(key)
    draws = [jax.random.randint(draw_key, (len(users), K), 0, NUM_ITEMS, dtype=jnp.int32)]
    for _ in range(rounds):
        rng, redraw_key = jax.random.split(rng)
        draws.append(jax.random.randint(redraw_key, (len(users), K), 0, NUM_ITEMS,
                                        dtype=jnp.int32))
    out = sampling.sample_negatives(torch.from_numpy(np.stack([np.asarray(d) for d in draws])),
                                    torch.from_numpy(users), torch.from_numpy(keys), NUM_ITEMS,
                                    K, exact=exact, max_resample_rounds=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    hits = sampling.contains_pairs(torch.from_numpy(keys), torch.from_numpy(users)[:, None],
                                   out, NUM_ITEMS)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jax_sampling.contains_pairs(
        jnp.asarray(keys), jnp.asarray(users)[:, None], jnp.asarray(ref), NUM_ITEMS)))


@pytest.mark.parametrize('kind', ['csr', 'bucketed'])
def test_degenerate_users(problem, kind):
    """User 0 (one non-positive) always draws it; user 2 (three
    non-positives) draws only those; user 1 (no non-positive) draws JAX's
    value, which the engine clamps before any gather: -1 from the CSR
    sampler, ``num_items`` (the sentinel that ends its table row) from the
    bucketed grouped sampler, here on the device builder's tables run on
    the CPU and JAX's uniforms.  The distinct sampler gives user 2 its
    three items then repeats, as JAX does."""
    mat, _ = problem
    users = np.repeat(np.arange(3, dtype=np.int32), 64)
    missing = [np.setdiff1d(np.arange(NUM_ITEMS), mat[u].indices) for u in range(3)]
    indptr, shifted = sampling.build_complement_tables(mat)
    if kind == 'bucketed':
        coo = mat.tocoo()
        specs, counts, users_g, _ = sampling.build_bucketed_complement_tables_torch(
            torch.as_tensor(coo.row), torch.as_tensor(coo.col), NUM_USERS, NUM_ITEMS,
            example_rows=torch.from_numpy(users))
        key = jax.random.PRNGKey(0)
        out = sampling.complement_sample_negatives_bucketed_grouped(
            torch.from_numpy(np.array(jax.random.uniform(key, (users_g.shape[0], 7)))),
            users_g, specs, counts, NUM_ITEMS, 5).numpy()
        ref = jax_sampling.complement_sample_negatives_bucketed_grouped_impl(
            key, jnp.asarray(users_g.numpy()),
            tuple((jnp.asarray(r.numpy()), jnp.asarray(t.numpy())) for r, t in specs),
            jnp.asarray(counts.numpy()), NUM_ITEMS, 5)
        np.testing.assert_array_equal(out, np.asarray(ref))
        slot_users = users_g.numpy()             # pad slots are user 0's
        assert (out[slot_users == 0] == missing[0][0]).all()
        assert (out[slot_users == 1] == NUM_ITEMS).all()
        assert np.isin(out[slot_users == 2], missing[2]).all()
        return
    u01 = _split_uniforms(jax.random.PRNGKey(0), 2, users.shape + (5,))
    out = sampling.complement_sample_negatives(
        u01, torch.from_numpy(users), torch.from_numpy(indptr), torch.from_numpy(shifted),
        NUM_ITEMS, 5).numpy()
    assert (out[users == 0] == missing[0][0]).all()
    assert (out[users == 1] == -1).all()
    assert np.isin(out[users == 2], missing[2]).all()
    distinct = sampling.distinct_complement_sample_negatives(
        u01, torch.from_numpy(users), torch.from_numpy(indptr), torch.from_numpy(shifted),
        NUM_ITEMS, 5).numpy()
    assert all(set(row) == set(missing[2]) for row in distinct[users == 2])
    ref = jax_sampling.distinct_complement_sample_negatives(
        jax.random.PRNGKey(0), jnp.asarray(users), jnp.asarray(indptr), jnp.asarray(shifted),
        NUM_ITEMS, 5)
    np.testing.assert_array_equal(distinct, np.asarray(ref))


def _pair(shuffle=True, K=3):
    rng = np.random.default_rng(1)
    users = rng.integers(0, 100, 3000)
    items = rng.integers(0, 300, 3000)
    kw = dict(users=users, items=items, num_users=100, num_items=300, allow_missing_ids=True,
              num_negative_samples=K, seed=0, check_num_negative_samples_is_valid=False)
    jax_inter, inter = JaxInteractions(**kw), Interactions(**kw)
    common = dict(batch_size=500, shuffle=shuffle, seed=0)
    jax_model = JaxMF(train=JaxLoader(jax_inter, **common), embedding_dim=4, lr=1e-1,
                      loss='adaptive', seed=0)
    model = MatrixFactorizationModel(train=InteractionsDataLoader(inter, **common),
                                     embedding_dim=4, lr=1e-1, loss='adaptive', seed=0,
                                     map_location='cpu')
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    return jax_model, model


SELECTIONS = [({}, 'bucketed'), ({'COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB': '0'}, 'csr'),
              ({'COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB': '0.04'}, 'csr'),
              ({'COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB': '0.05'}, 'bucketed'),
              ({'COLLIE_TPU_SAMPLER': 'padded'}, 'padded'),
              ({'COLLIE_TPU_SAMPLER': 'csr'}, 'csr'),
              ({'COLLIE_TPU_SAMPLER': 'bucketed', 'COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB': '0'},
               'bucketed'),
              ({'COLLIE_TPU_SAMPLER': 'other'}, 'csr')]
TABLE_OF = {'bucketed': 'bucket_specs', 'padded': 'shifted_pad', 'csr': 'indptr'}


@pytest.mark.parametrize('env,kind', SELECTIONS)
def test_routing_matches_jax(env, kind, monkeypatch):
    """The sampler each package's engine builds tables for, by env and
    budget (the pattern of ``tests/test_device_sampling.py:206,244``):
    ``kind`` is JAX's, and the port's too but for ``padded``, which takes
    the port's CSR sampler (its negatives are the padded sampler's).  The
    bucketed tables take 51,200 B here, as much as the padded table, so
    ``auto`` never takes ``padded`` (bucketed <= padded always): a budget
    of 0.04 MB routes to ``csr``, 0.05 MB to ``bucketed``."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_model, model = _pair()
    _, jax_data, _, _ = jax_build_epoch(jax_model, jax_model.optimizer_specs(), [True, True],
                                        jax_model.train_loader, shuffle=True)
    fn, data, _, _ = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], model.train_loader, shuffle=True)
    port_kind = 'csr' if kind == 'padded' else kind
    assert fn.sampler == port_kind
    for other, table in TABLE_OF.items():
        assert (table in jax_data) == (other == kind), table
        assert (table in data) == (other == port_kind), table


@pytest.mark.parametrize('kind', ['padded', 'csr'])
def test_engine_epoch_equals_jax_given_its_draws(kind, monkeypatch):
    """Under ``COLLIE_TPU_SAMPLER=kind`` the port's epoch (the CSR sampler
    for both) holds JAX's ``kind`` sampler's negatives, and its training
    JAX's engine's under the same setting."""
    monkeypatch.setenv('COLLIE_TPU_SAMPLER', kind)
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_draws)
    jax_model, model = _pair()
    fn, data, S, _ = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], model.train_loader, shuffle=True)
    assert fn.sampler == 'csr'
    batches = fn.epoch_batches(0, 1)
    # JAX's sampler on the epoch's batch positions, with its own key
    sample_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 1), 3)[1]
    users = jnp.asarray(batches['users'].reshape(-1).numpy())
    mat = model.train_loader.mat
    if kind == 'padded':
        pad, counts = jax_sampling.build_padded_complement_table(mat)
        ref = jax_sampling.complement_sample_negatives_padded_impl(
            sample_rng, users, jnp.asarray(pad), jnp.asarray(counts), 300, 3, dedup_rounds=1)
    else:
        indptr, shifted = jax_sampling.build_complement_tables(mat)
        ref = jax_sampling.complement_sample_negatives_impl(
            sample_rng, users, jnp.asarray(indptr), jnp.asarray(shifted), 300, 3,
            dedup_rounds=1)
    np.testing.assert_array_equal(batches['neg_items'].reshape(-1, 3).numpy(), np.asarray(ref))
    assert batches['users'].shape == (S, 500)

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


def test_a_user_holding_every_item_trains_on_the_bucketed_reorder_path(monkeypatch):
    """User 0 holds all 30 items, so the bucketed sampler hands it the
    sentinel ``num_items``; the bucket pads pass 2% of the examples, so the
    epoch takes the reorder path, which clamps the sentinel into the item
    range before any gather, as the slot-domain epoch does.  (The JAX
    package's reorder path passes it on and fits this data to NaN, so no
    parity is held here.)"""
    rng = np.random.default_rng(0)
    users = np.concatenate([np.zeros(30, np.int64), np.repeat(np.arange(1, 40), 5)])
    items = np.concatenate([np.arange(30)] + [rng.choice(30, 5, replace=False)
                                              for _ in range(39)])
    inter = Interactions(users=users, items=items, num_users=40, num_items=30,
                         num_negative_samples=3, check_num_negative_samples_is_valid=False,
                         seed=0)
    model = MatrixFactorizationModel(
        train=InteractionsDataLoader(inter, batch_size=64, shuffle=True), embedding_dim=8,
        map_location='cpu')
    seen, real = [], scan_engine.train_steps

    def recording(model, specs, active, params, opt_states, batches, *args, **kwargs):
        seen.append(batches['neg_items'].clone())
        return real(model, specs, active, params, opt_states, batches, *args, **kwargs)

    monkeypatch.setattr(scan_engine, 'train_steps', recording)
    fn, data, _, _ = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], model.train_loader, shuffle=True)
    assert fn.sampler == 'bucketed' and 'pos_of' in data          # the reorder path
    CollieTrainer(model, max_epochs=1, seed=0, verbosity=0, logger=False).fit(model)
    assert seen
    negs = torch.cat([s.reshape(-1) for s in seen])
    assert int(negs.min()) >= 0 and int(negs.max()) < 30
    assert all(bool(torch.isfinite(v).all()) for v in model.params.values())
