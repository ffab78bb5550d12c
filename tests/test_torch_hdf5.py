"""The out-of-core HDF5 tier in the port against collie_tpu, on the CPU.

Counterparts of ``tests/test_hdf5_chunk.py``, the HDF5 cases of
``tests/test_interactions.py`` and ``tests/test_utils.py`` and the HDF5
tests of ``tests/test_whole_fit.py``, each run against collie_tpu on the
same store.  Reads, loader batches and chunk orders are numpy in both
packages and must be equal.  Fits start from the same params (carried
across with ``params_from_jax``); a chunk-tier fit gets JAX's chunk draws
(``jax_chunk_draws`` stands in for ``scan_engine.draw_chunk``: the Feistel
keys and negatives JAX derives from ``fold_in(fold_in(PRNGKey(seed),
epoch), chunk)``), a per-step fit needs none (the loader's numpy draws are
the same).  Fits are held at ``tests/test_torch_training.py``'s
tolerances: params within ``5e-4 * max|param|``, per-epoch losses within
rtol 1e-4.
"""
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import collie_tpu.training.scan_engine as jax_engine
from collie_tpu.data import HDF5Interactions as JaxHDF5Interactions
from collie_tpu.data import HDF5InteractionsDataLoader as JaxHDF5Loader
from collie_tpu.data import PrefetchLoader as JaxPrefetchLoader
from collie_tpu.data import write_hdf5_meta as jax_write_meta
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu.utils import pandas_df_to_hdf5 as jax_df_to_hdf5
from collie_tpu_torch import (ApproximateNegativeSamplingInteractionsDataLoader, CollieTrainer,
                              HDF5Interactions, HDF5InteractionsDataLoader,
                              InteractionsDataLoader, MatrixFactorizationModel, PrefetchLoader,
                              params_from_jax, pandas_df_to_hdf5, write_hdf5_meta)
from collie_tpu_torch.training import scan_engine, trainer as trainer_module
from collie_tpu_torch.training.scan_engine import draw_chunk, hdf5_chunk_plan

from tests.test_torch_training import Recorder, _assert_params_close

# tests/test_interactions.py's toy store
USERS = [0, 0, 0, 1, 1, 1, 2, 2]
ITEMS = [0, 1, 2, 1, 2, 3, 0, 2]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_chunk_draws(seed, epoch_idx, chunk_idx, device, perm_n, neg_shape, num_items,
                    num_steps, dropout):
    """The JAX chunk's draws (``collie_tpu/training/scan_engine.py:736-747``),
    as the port's ``draw_chunk`` returns them."""
    assert not dropout, 'the parity fits have no dropout'
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx),
                             chunk_idx)
    perm_rng, sample_rng, _ = jax.random.split(rng, 3)
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    negs = torch.from_numpy(np.array(jax.random.randint(
        sample_rng, neg_shape, 0, num_items, dtype=jnp.int32)))
    return keys, negs, None


def _write_store(path, users, items, num_users, num_items):
    with h5py.File(path, 'w') as f:
        g = f.require_group('interactions')
        g.create_dataset('user_id', data=users)
        g.create_dataset('item_id', data=items)
    write_hdf5_meta(path, num_users, num_items)


@pytest.fixture()
def ragged_store(tmp_path):
    """``tests/test_hdf5_chunk.py``'s store: n % B != 0 and the 10 steps
    are not a whole number of 4-step chunks."""
    rng = np.random.default_rng(0)
    NU, NI, N = 120, 90, 256 * 9 + 37
    users = rng.integers(0, NU, N).astype(np.int32)
    items = rng.integers(0, NI, N).astype(np.int32)
    path = str(tmp_path / 'x.h5')
    _write_store(path, users, items, NU, NI)
    return path, NU, NI, N


@pytest.fixture()
def made_chunks(monkeypatch):
    """The step counts the trainer's chunk tier built chunk functions
    for (empty when a fit took another tier)."""
    made = []
    build = trainer_module.build_hdf5_chunk_make

    def recording(*args, **kwargs):
        make = build(*args, **kwargs)

        def make_recorded(num_steps):
            made.append(num_steps)
            return make(num_steps)
        return make_recorded

    monkeypatch.setattr(trainer_module, 'build_hdf5_chunk_make', recording)
    return made


def _port_fit(path, seed, epochs=3, chunk_steps='4', epoch_mode='auto', lr=1e-1,
              params=None, logger=None, **loader_kw):
    """``tests/test_hdf5_chunk.py``'s ``_fit`` in the port (optionally from
    given params)."""
    old = os.environ.get('COLLIE_TPU_HDF5_CHUNK_STEPS')
    os.environ['COLLIE_TPU_HDF5_CHUNK_STEPS'] = chunk_steps
    try:
        loader = HDF5InteractionsDataLoader(hdf5_path=path, batch_size=256, shuffle=True,
                                            num_negative_samples=5, seed=seed, **loader_kw)
        model = MatrixFactorizationModel(train=loader, embedding_dim=8, lr=lr,
                                         loss='adaptive_hinge', seed=seed, map_location='cpu')
        if params is not None:
            model.load_params(params_from_jax(params, 'cpu'))
        trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=seed,
                                epoch_mode=epoch_mode, logger=logger)
        trainer.fit(model)
        return model, trainer
    finally:
        if old is None:
            os.environ.pop('COLLIE_TPU_HDF5_CHUNK_STEPS', None)
        else:
            os.environ['COLLIE_TPU_HDF5_CHUNK_STEPS'] = old


def _jax_fit(path, seed, epochs=3, chunk_steps='4', epoch_mode='auto', lr=1e-1,
             logger=None):
    old = os.environ.get('COLLIE_TPU_HDF5_CHUNK_STEPS')
    os.environ['COLLIE_TPU_HDF5_CHUNK_STEPS'] = chunk_steps
    try:
        loader = JaxHDF5Loader(hdf5_path=path, batch_size=256, shuffle=True,
                               num_negative_samples=5, seed=seed)
        model = JaxMF(train=loader, embedding_dim=8, lr=lr, loss='adaptive_hinge', seed=seed)
        params = {k: np.asarray(v) for k, v in model.params.items()}
        trainer = JaxTrainer(model, max_epochs=epochs, verbosity=0, seed=seed,
                             epoch_mode=epoch_mode, logger=logger)
        trainer.fit(model)
        return model, trainer, params
    finally:
        if old is None:
            os.environ.pop('COLLIE_TPU_HDF5_CHUNK_STEPS', None)
        else:
            os.environ['COLLIE_TPU_HDF5_CHUNK_STEPS'] = old


def _losses(recorder):
    return [m['train_loss_epoch'] for _, m in recorder.metrics if 'train_loss_epoch' in m]


def _params(model):
    return {k: np.asarray(v.float() if torch.is_tensor(v) else v)
            for k, v in model.params.items()}


def _fits_agree(path, seed, epochs, chunk_steps, epoch_mode='auto', lr=1e-1):
    """Both packages fit the store from JAX's initial params; returns the
    port's ``(model, trainer)`` after holding losses and params."""
    jax_rec, rec = Recorder(), Recorder()
    jax_model, jax_trainer, init = _jax_fit(path, seed, epochs, chunk_steps, epoch_mode, lr,
                                            logger=jax_rec)
    model, trainer = _port_fit(path, seed, epochs, chunk_steps, epoch_mode, lr, params=init,
                               logger=rec)
    np.testing.assert_allclose(_losses(rec), _losses(jax_rec), rtol=1e-4)
    _assert_params_close(_params(jax_model), _params(model))
    assert trainer.global_step == jax_trainer.global_step
    return model, trainer


# ------------------------------------------------------- the chunk plan


def test_chunk_plan_pow2_tail():
    cases = {(41, 16): [(0, 16), (16, 16), (32, 8), (40, 1)], (3, 16): [(0, 2), (2, 1)],
             (16, 16): [(0, 16)], (1, 64): [(0, 1)], (245, 64): None}
    for (total, chunk), want in cases.items():
        plan = hdf5_chunk_plan(total, chunk)
        assert plan == jax_engine.hdf5_chunk_plan(total, chunk)
        if want is not None:
            assert plan == want
    assert [s for _, s in hdf5_chunk_plan(245, 64)] == [64, 64, 64, 32, 16, 4, 1]


def test_chunk_plan_covers_exactly_and_bounds_programs():
    for total in (1, 5, 17, 63, 64, 65, 200, 1023):
        plan = hdf5_chunk_plan(total, 64)
        assert plan == jax_engine.hdf5_chunk_plan(total, 64)
        pos = 0
        for start, steps in plan:
            assert start == pos and steps >= 1
            pos += steps
        assert pos == total
        assert len({s for _, s in plan}) <= 7


def test_draw_chunk_is_a_function_of_seed_epoch_and_chunk():
    a = draw_chunk(3, 1, 2, 'cpu', 512, (512, 5), 90, 2, True)
    b = draw_chunk(3, 1, 2, 'cpu', 512, (512, 5), 90, 2, True)
    c = draw_chunk(3, 1, 3, 'cpu', 512, (512, 5), 90, 2, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
    assert not torch.equal(a[1], c[1])
    keys, negs, seeds = a
    assert keys.shape == (4,) and int(keys.min()) >= 0 and int(keys.max()) < 2 ** 31 - 1
    assert negs.dtype == torch.int32 and negs.shape == (512, 5)
    assert int(negs.min()) >= 0 and int(negs.max()) < 90
    assert len(seeds) == 2
    keys, _, seeds = draw_chunk(3, 1, 2, 'cpu', None, (256, 5), 90, 1, False)
    assert keys is None and seeds is None


# ------------------------------------------------------- the chunk tier


def test_chunked_tier_selected_and_trains_like_jax(ragged_store, monkeypatch, made_chunks,
                                                   capsys):
    """The tier is selected (chunk functions for 4 and 2 steps: 10 steps =
    2 x 4 + a tail of 2), its fit equals JAX's on JAX's chunk draws, the
    counters are JAX's, and the route says so."""
    monkeypatch.setattr(scan_engine, 'draw_chunk', jax_chunk_draws)
    path, NU, NI, N = ragged_store
    model, trainer = _fits_agree(path, seed=7, epochs=3, chunk_steps='4')
    assert set(made_chunks) == {4, 2}
    for k, v in model.params.items():
        assert torch.isfinite(v).all(), k
    assert trainer.last_fit_examples_per_sec is not None
    assert trainer.global_step == 3 * (-(-N // 256))
    assert [row['steps'] for row in trainer.epoch_log] == [10, 10, 10]
    capsys.readouterr()
    CollieTrainer(model, max_epochs=4, verbosity=1, seed=7).fit(model)
    assert 'route: epoch: hdf5 chunks' in capsys.readouterr().out


def test_chunked_tier_deterministic(ragged_store):
    path, *_ = ragged_store
    m1, _ = _port_fit(path, seed=11)
    m2, _ = _port_fit(path, seed=11)
    for k in m1.params:
        assert torch.equal(m1.params[k], m2.params[k]), k
    m3, _ = _port_fit(path, seed=12)
    assert any(not torch.equal(m1.params[k], m3.params[k]) for k in m1.params)


@pytest.mark.parametrize('shuffle_kind,dropout', [('feistel', 0.0), ('feistel', 0.2)])
def test_chunked_tier_other_shuffles_and_dropout_are_seeded(ragged_store, monkeypatch,
                                                            shuffle_kind, dropout):
    """A model without dropout and one with dropout (one seed a step from
    ``draw_chunk``) train through the chunk tier's Feistel shuffle, the one
    it has (``shuffle_kind``), finite, and repeat bit for bit from one
    seed."""
    path, *_ = ragged_store
    params = []
    for _ in range(2):
        loader = HDF5InteractionsDataLoader(hdf5_path=path, batch_size=256, shuffle=True,
                                            num_negative_samples=5, seed=3)
        model = MatrixFactorizationModel(train=loader, embedding_dim=8, lr=1e-1, seed=3,
                                         loss='adaptive_hinge', dropout_p=dropout,
                                         map_location='cpu')
        monkeypatch.setenv('COLLIE_TPU_HDF5_CHUNK_STEPS', '4')
        CollieTrainer(model, max_epochs=2, verbosity=0, seed=3).fit(model)
        params.append(model.params)
    for k, v in params[0].items():
        assert torch.isfinite(v).all(), k
        assert torch.equal(v, params[1][k]), k


def test_chunked_tier_learns_planted_structure(tmp_path):
    """Users < 40 interact only with items < 30: after 12 epochs in-block
    items outscore the rest."""
    rng = np.random.default_rng(3)
    NU, NI, N = 80, 60, 6000
    users = rng.integers(0, 40, N).astype(np.int32)
    items = rng.integers(0, 30, N).astype(np.int32)
    users[0], items[0] = NU - 1, NI - 1
    users[1], items[1] = 0, 0
    path = str(tmp_path / 'planted.h5')
    _write_store(path, users, items, NU, NI)
    model, _ = _port_fit(path, seed=5, epochs=12, chunk_steps='8')
    scores = model.score_all_items(model.params, torch.arange(5)).detach().numpy()
    assert scores[:, :30].mean() > scores[:, 30:].mean()


@pytest.mark.parametrize('chunk_steps,epoch_mode', [('0', 'auto'), ('4', 'step')])
def test_other_routes_take_the_per_step_path_like_jax(ragged_store, made_chunks, chunk_steps,
                                                      epoch_mode):
    """``COLLIE_TPU_HDF5_CHUNK_STEPS=0`` and ``epoch_mode='step'`` bypass
    the chunk tier; the per-step fit over the loader's numpy batches equals
    JAX's."""
    path, *_ = ragged_store
    _fits_agree(path, seed=7, epochs=1, chunk_steps=chunk_steps, epoch_mode=epoch_mode)
    assert made_chunks == []


def test_chunked_loss_matches_per_step_scale(ragged_store):
    """The chunk tier's epoch loss is the mean over real steps, at the
    per-step path's scale (their draws differ, so within 5%)."""
    path, *_ = ragged_store
    losses = {}
    for label, mode in (('chunk', 'auto'), ('step', 'step')):
        rec = Recorder()
        _port_fit(path, seed=21, epochs=1, epoch_mode=mode, lr=1e-3, logger=rec)
        losses[label] = _losses(rec)[0]
    assert losses['chunk'] == pytest.approx(losses['step'], rel=0.05)


def test_chunk_order_and_padding_follow_jax(ragged_store, monkeypatch):
    """Every chunk the trainer hands its chunk function: the plan in
    JAX's chunk order, the store's rows, then id-0 padding with mask 0 in
    the last chunk only."""
    path, NU, NI, N = ragged_store
    seen = []
    build = trainer_module.build_hdf5_chunk_make

    def recording(*args, **kwargs):
        make = build(*args, **kwargs)

        def make_recorded(num_steps):
            fn = make(num_steps)

            def chunk_fn(params, opt_states, users, items, mask, seed, epoch_idx, chunk_idx):
                seen.append((epoch_idx, chunk_idx, users.clone(), items.clone(), mask.clone()))
                return fn(params, opt_states, users, items, mask, seed, epoch_idx, chunk_idx)
            return chunk_fn
        return make_recorded

    monkeypatch.setattr(trainer_module, 'build_hdf5_chunk_make', recording)
    _port_fit(path, seed=7, epochs=2)
    with h5py.File(path, 'r') as f:
        users, items = f['interactions/user_id'][:], f['interactions/item_id'][:]
    plan = jax_engine.hdf5_chunk_plan(-(-N // 256), 4)
    for epoch in (1, 2):
        order = np.random.default_rng((7, epoch)).permutation(len(plan))
        got = [s for s in seen if s[0] == epoch]
        assert [s[1] for s in got] == list(range(len(plan)))
        for (_, _, u, i, m), j in zip(got, order):
            start, steps = plan[j]
            lo, hi = start * 256, min((start + steps) * 256, N)
            real = hi - lo
            assert u.shape == (steps * 256,) and u.dtype == torch.int32
            np.testing.assert_array_equal(u[:real].numpy(), users[lo:hi])
            np.testing.assert_array_equal(i[:real].numpy(), items[lo:hi])
            assert m[:real].eq(1).all() and m[real:].eq(0).all()
            assert u[real:].eq(0).all() and i[real:].eq(0).all()
            assert real == steps * 256 or hi == N


# ------------------------------------------------ reads, loaders, stores


def test_read_chunk_matches_store_and_jax(ragged_store):
    path, NU, NI, N = ragged_store
    loader = HDF5InteractionsDataLoader(hdf5_path=path, batch_size=256,
                                        num_negative_samples=5, seed=0)
    u, i = loader.interactions.read_chunk(100, 300)
    ju, ji = JaxHDF5Interactions(path, seed=0).read_chunk(100, 300)
    assert u.dtype == i.dtype == np.int32
    with h5py.File(path, 'r') as f:
        np.testing.assert_array_equal(u, f['interactions/user_id'][100:300].astype(np.int32))
        np.testing.assert_array_equal(i, f['interactions/item_id'][100:300].astype(np.int32))
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize('shuffle,drop_last', [(True, False), (False, True), (True, True)])
def test_loader_batches_equal_jax(ragged_store, shuffle, drop_last):
    """Two epochs of the loader: chunk order, in-chunk shuffle, negatives,
    padding and mask equal JAX's bit for bit."""
    path, *_ = ragged_store
    kw = dict(hdf5_path=path, batch_size=256, shuffle=shuffle, drop_last=drop_last,
              num_negative_samples=5, seed=3)
    port, ref = HDF5InteractionsDataLoader(**kw), JaxHDF5Loader(**kw)
    assert len(port) == len(ref)
    for _ in range(2):
        a, b = list(port), list(ref)
        assert len(a) == len(b) == len(ref)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], np.asarray(y[k]), err_msg=k)


def test_hdf5_loader_seed_reaches_interactions(tmp_path):
    """``tests/test_whole_fit.py:193``: a seeded loader builds a seeded
    ``HDF5Interactions``; two such loaders give the same stream, JAX's."""
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(seed=3)
    path = str(tmp_path / 'inter.h5')
    pandas_df_to_hdf5(df, path)
    kw = dict(hdf5_path=path, batch_size=1024, shuffle=True, seed=7, num_users=943,
              num_items=1682, num_negative_samples=4)

    def stream(cls):
        loader = cls(**kw)
        assert loader.interactions.seed == 7
        return [{k: np.asarray(v).copy() for k, v in b.items()} for b in loader]

    a, b, ref = stream(HDF5InteractionsDataLoader), stream(HDF5InteractionsDataLoader), \
        stream(JaxHDF5Loader)
    assert len(a) == len(ref)
    for x, y, z in zip(a, b, ref):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_array_equal(x[k], z[k])


@pytest.mark.parametrize('group', ['16', '1'])
def test_per_step_hdf5_fit_matches_jax_at_any_step_group(tmp_path, monkeypatch, group):
    """``tests/test_whole_fit.py:220``: JAX's per-step path groups steps
    into scans of ``COLLIE_TPU_STEP_SCAN_GROUP``, which changes no value;
    the port's per-step fit over the same store equals JAX's at either
    group size.  At lr 1e-2: at the JAX test's lr 0.1 the ~98 steps an
    epoch of this data turn rounding-level differences into flipped
    hardest negatives, and the two fits (equal losses in epoch 1 to 4e-6)
    end 20% of max|param| apart within one epoch."""
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    monkeypatch.setenv('COLLIE_TPU_STEP_SCAN_GROUP', group)
    monkeypatch.setenv('COLLIE_TPU_HDF5_CHUNK_STEPS', '0')
    path = str(tmp_path / 'inter.h5')
    pandas_df_to_hdf5(generate_interactions_df(seed=3), path)
    kw = dict(hdf5_path=path, batch_size=1024, shuffle=True, seed=0, num_users=943,
              num_items=1682, num_negative_samples=4)
    jax_model = JaxMF(train=JaxHDF5Loader(**kw), embedding_dim=8, lr=1e-2, loss='adaptive',
                      seed=0)
    init = {k: np.asarray(v) for k, v in jax_model.params.items()}
    model = MatrixFactorizationModel(train=HDF5InteractionsDataLoader(**kw), embedding_dim=8,
                                     lr=1e-2, loss='adaptive', seed=0, map_location='cpu')
    model.load_params(params_from_jax(init, 'cpu'))
    JaxTrainer(jax_model, max_epochs=2, verbosity=0, seed=0).fit(jax_model)
    CollieTrainer(model, max_epochs=2, verbosity=0, seed=0).fit(model)
    _assert_params_close(_params(jax_model), _params(model))


def test_prefetch_loader_trains_hdf5_like_jax(tmp_path):
    """``tests/test_interactions.py:224``: a ``PrefetchLoader`` over the
    HDF5 loader trains through the per-step path; with a seeded loader
    its fit equals JAX's."""
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(num_users=80, num_items=160, num_interactions=2000, seed=5)
    path = str(tmp_path / 'p.h5')
    pandas_df_to_hdf5(df, path)
    write_hdf5_meta(path, num_users=80, num_items=160)
    kw = dict(hdf5_path=path, batch_size=256, shuffle=True, num_negative_samples=4, seed=5)
    jax_model = JaxMF(train=JaxPrefetchLoader(JaxHDF5Loader(**kw)), embedding_dim=8,
                      loss='adaptive', seed=0)
    init = {k: np.asarray(v) for k, v in jax_model.params.items()}
    model = MatrixFactorizationModel(train=PrefetchLoader(HDF5InteractionsDataLoader(**kw)),
                                     embedding_dim=8, loss='adaptive', seed=0,
                                     map_location='cpu')
    model.load_params(params_from_jax(init, 'cpu'))
    JaxTrainer(jax_model, max_epochs=2, verbosity=0, seed=0).fit(jax_model)
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0, seed=0)
    trainer.fit(model)
    assert model.hparams['num_epochs_completed'] == 2
    assert trainer.global_step == 2 * len(model.train_loader)
    _assert_params_close(_params(jax_model), _params(model))


def test_hdf5_one_indexed_store_raises(tmp_path):
    """``tests/test_interactions.py:285``: JAX's message."""
    df = pd.DataFrame({'user_id': np.array(USERS) + 1, 'item_id': np.array(ITEMS) + 1})
    path = str(tmp_path / 'one_indexed.h5')
    pandas_df_to_hdf5(df, path)
    with pytest.raises(ValueError, match='must both be 0') as port_err:
        HDF5Interactions(hdf5_path=path)
    with pytest.raises(ValueError) as jax_err:
        JaxHDF5Interactions(hdf5_path=path)
    assert str(port_err.value) == str(jax_err.value)


def test_empty_store_cannot_infer_sizes(tmp_path):
    path = str(tmp_path / 'empty.h5')
    _write_store(path, np.zeros(0, np.int32), np.zeros(0, np.int32), 3, 4)
    with h5py.File(path, 'a') as f:
        del f['meta']
    with pytest.raises(ValueError, match='empty HDF5 store'):
        HDF5Interactions(hdf5_path=path)
    assert HDF5Interactions(hdf5_path=path, num_users=3, num_items=4).num_interactions == 0


def test_all_data_loaders_output_equal(tmp_path):
    """``tests/test_interactions.py:300``: the three loader families yield
    the same positives over the same unshuffled data and proxy the same
    sizes."""
    kwargs = dict(batch_size=3, shuffle=False, drop_last=False, seed=7)
    inter_dl = InteractionsDataLoader(users=USERS, items=ITEMS, num_negative_samples=2,
                                      check_num_negative_samples_is_valid=False, **kwargs)
    approx_dl = ApproximateNegativeSamplingInteractionsDataLoader(
        users=USERS, items=ITEMS, num_negative_samples=2,
        check_num_negative_samples_is_valid=False, **kwargs)
    path = str(tmp_path / 'same.h5')
    pandas_df_to_hdf5(pd.DataFrame({'user_id': USERS, 'item_id': ITEMS}), path)
    write_hdf5_meta(path, num_users=3, num_items=4)
    hdf5_dl = HDF5InteractionsDataLoader(hdf5_path=path, num_negative_samples=2, **kwargs)

    assert inter_dl.num_users == approx_dl.num_users == hdf5_dl.num_users == 3
    assert inter_dl.num_items == approx_dl.num_items == hdf5_dl.num_items == 4
    assert (inter_dl.num_interactions == approx_dl.num_interactions
            == hdf5_dl.num_interactions == 8)
    assert len(inter_dl) == len(approx_dl) == len(hdf5_dl) == 3

    def positive_stream(dl):
        users, items = [], []
        for batch in dl:
            keep = batch['mask'].astype(bool)
            users.extend(batch['users'][keep].tolist())
            items.extend(batch['pos_items'][keep].tolist())
        return users, items

    streams = [positive_stream(dl) for dl in (inter_dl, approx_dl, hdf5_dl)]
    assert streams[0] == streams[1] == streams[2] == (USERS, ITEMS)
    for dl in (inter_dl, approx_dl, hdf5_dl):
        for batch in dl:
            assert batch['neg_items'].shape[-1] == 2


def test_hdf5_loader_drop_last(tmp_path):
    """``tests/test_interactions.py:330``."""
    path = str(tmp_path / 'dl.h5')
    pandas_df_to_hdf5(pd.DataFrame({'user_id': USERS, 'item_id': ITEMS}), path)
    write_hdf5_meta(path, num_users=3, num_items=4)
    dl = HDF5InteractionsDataLoader(hdf5_path=path, batch_size=3, drop_last=True, seed=0)
    batches = list(dl)
    assert len(dl) == len(batches) == 2
    assert all(batch['mask'].all() for batch in batches)


@pytest.fixture()
def toy_df():
    return pd.DataFrame({'user_id': USERS, 'item_id': ITEMS,
                         'rating': np.arange(1, 9, dtype=np.float64)})


def test_pandas_df_to_hdf5_append(tmp_path, toy_df):
    """``tests/test_utils.py:93``, and the same appends through JAX's
    writer give the same store."""
    path, ref = tmp_path / 'data.h5', tmp_path / 'ref.h5'
    for _ in range(2):
        pandas_df_to_hdf5(toy_df, path)
        jax_df_to_hdf5(toy_df, ref)
    with h5py.File(path, 'r') as f, h5py.File(ref, 'r') as g:
        assert f['interactions']['user_id'].shape[0] == 2 * len(toy_df)
        assert list(f['interactions'].attrs['column_order']) == \
            list(g['interactions'].attrs['column_order']) == ['user_id', 'item_id', 'rating']
        for col in toy_df.columns:
            np.testing.assert_array_equal(f['interactions'][col][:], g['interactions'][col][:])
    extra = toy_df.assign(weight=np.ones(len(toy_df)))[['weight', 'user_id', 'item_id', 'rating']]
    pandas_df_to_hdf5(extra, path)
    with h5py.File(path, 'r') as f:
        assert list(f['interactions'].attrs['column_order']) == \
            ['user_id', 'item_id', 'rating', 'weight']


def test_hdf5_interactions_roundtrip(tmp_path, toy_df):
    """``tests/test_utils.py:184``, with the draws of one seed equal to
    JAX's."""
    path = str(tmp_path / 'inter.h5')
    pandas_df_to_hdf5(toy_df, path)
    write_hdf5_meta(path, num_users=3, num_items=4)
    inter = HDF5Interactions(hdf5_path=path, num_negative_samples=2, shuffle=True, seed=4)
    ref = JaxHDF5Interactions(hdf5_path=path, num_negative_samples=2, shuffle=True, seed=4)
    assert (inter.num_users, inter.num_items, len(inter)) == (3, 4, 8)
    (users, items), negs = inter[(0, 5)]
    (ref_users, ref_items), ref_negs = ref[(0, 5)]
    assert len(users) == 5 and negs.shape == (5, 2)
    for a, b in ((users, ref_users), (items, ref_items), (negs, ref_negs)):
        np.testing.assert_array_equal(a, b)
    loader = HDF5InteractionsDataLoader(interactions=inter, batch_size=3, shuffle=True)
    batches = list(loader)
    assert len(batches) == 3
    assert sum(int(b['mask'].sum()) for b in batches) == 8
    with pytest.raises(AttributeError, match='out-of-core'):
        _ = loader.mat


@pytest.mark.parametrize('n', [2, -3, 0, 100, -100])
def test_head_and_tail_clamp_like_jax(tmp_path, toy_df, n):
    """``head`` / ``tail``: the reference's clamping, the stored column
    order and the row offsets as the index, equal to JAX's."""
    path = str(tmp_path / 'inter.h5')
    pandas_df_to_hdf5(toy_df, path)
    inter, ref = HDF5Interactions(hdf5_path=path), JaxHDF5Interactions(hdf5_path=path)
    pd.testing.assert_frame_equal(inter.head(n), ref.head(n))
    pd.testing.assert_frame_equal(inter.tail(n), ref.tail(n))


def test_hdf5_infer_dims_without_meta(tmp_path, toy_df):
    path = str(tmp_path / 'inter2.h5')
    pandas_df_to_hdf5(toy_df, path)
    inter = HDF5Interactions(hdf5_path=path)
    assert (inter.num_users, inter.num_items) == (3, 4)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_stores_cross_between_packages(tmp_path, toy_df, writer):
    """A store and its meta written by either package read the same in
    both: sizes, chunks, head and tail."""
    path = str(tmp_path / f'{writer}.h5')
    df_to_hdf5, meta = ((pandas_df_to_hdf5, write_hdf5_meta) if writer == 'port'
                        else (jax_df_to_hdf5, jax_write_meta))
    df_to_hdf5(toy_df, path)
    meta(path, num_users=5, num_items=7)
    inter, ref = HDF5Interactions(hdf5_path=path), JaxHDF5Interactions(hdf5_path=path)
    assert (inter.num_users, inter.num_items) == (ref.num_users, ref.num_items) == (5, 7)
    for a, b in zip(inter.read_chunk(1, 6), ref.read_chunk(1, 6)):
        np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(inter.head(3), ref.head(3))


def test_package_imports_without_h5py():
    """``import collie_tpu_torch`` with ``h5py`` blocked (the card's
    machine has none); only reading or writing a store needs it."""
    code = ('import sys; sys.modules["h5py"] = None\n'
            'import collie_tpu_torch\n'
            'from collie_tpu_torch import HDF5InteractionsDataLoader, write_hdf5_meta\n'
            'from collie_tpu_torch.training import scan_engine, trainer\n'
            'try:\n'
            '    write_hdf5_meta("x.h5", 1, 1)\n'
            'except ImportError:\n'
            '    print("needs h5py")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'needs h5py'
