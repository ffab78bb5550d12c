"""The sparse forms of the port's ``calculate_loss`` and the bfloat16
selection pass, against collie_tpu at its defaults.

With ``COLLIE_TPU_SPARSE_ADAPTIVE`` and ``COLLIE_TPU_BF16_SELECT`` unset,
both packages take, for ``K > 1``, training and no dropout, the
sparse-hardest backward (adaptive hinge and BPR) or the WARP first
violation, MF selecting in bfloat16 and every other model in float32.  On
the same params (numpy draws carried with ``params_from_jax``, as in
``tests/test_torch_zoo.py`` and ``tests/test_torch_multi_stage.py``) and
the same batch:

* losses within rtol 1e-5, every gradient within 1e-5 * max|ref| (the
  largest element of JAX's gradients of all params);
* the selected negatives equal, except rows whose two best JAX selection
  scores lie within 1e-6 but not exactly equal (for WARP: a JAX selection
  hinge within 1e-6 of zero), which are counted and must be fewer than 1%
  of the batch.

Then the counterparts of JAX's ``tests/test_sparse_adaptive.py`` and
``tests/test_bf16_select.py`` in the port: the sparse forms against the
dense one (loss rtol 1e-6, gradients rtol 1e-5 / atol 1e-7, float32
selection), each precondition falling back to the dense form, the
bfloat16 pass (off: the float32 scores exactly; on: within 2e-2 *
max|f32|; fused and named layouts alike; subclasses in float32), a knob
flipped between two fits, and a bfloat16-selection fit in the float32
selection's quality regime.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collie_tpu_torch
from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, MatrixFactorizationModel
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.models.base import BasePipeline
from collie_tpu_torch.ops import losses as loss_lib

from tests.test_torch_multi_stage import build_pair as multi_stage_pair
from tests.test_torch_multi_stage import data as multi_stage_data  # noqa: F401
from tests.test_torch_zoo import build_pair as zoo_pair
from tests.test_torch_zoo import data as zoo_data  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_SCALE = 1e-5
NEAR_TIE = 1e-6
MAX_NEAR_TIE_SHARE = 0.01
B = 256
GENRES = 3
META_WEIGHT = 0.3
# model -> (pair source, variant or stage, kwargs); no dropout, so the sparse
# forms apply
MODELS = {
    'mf': ('zoo', 'mf_dropout', dict(dropout_p=0.0)),
    'mlp_mf': ('zoo', 'mlp_mf', dict(dropout_p=0.0)),
    'nonlinear_mf': ('zoo', 'nonlinear_mf', dict(dense_dropout_p=0.0,
                                                 embedding_dropout_p=0.0)),
    'neucf': ('zoo', 'neucf', dict(dropout_p=0.0)),
    'deep_fm': ('zoo', 'deep_fm', dict(dropout_p=0.0)),
    'cold_start_item_buckets': ('multi_stage', 'item_buckets', {}),
    'cold_start_no_buckets': ('multi_stage', 'no_buckets', {}),
}


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    for knob in ('COLLIE_TPU_SPARSE_ADAPTIVE', 'COLLIE_TPU_BF16_SELECT',
                 'COLLIE_TPU_FUSED_TABLES', 'COLLIE_TPU_FUSED_EPOCH'):
        monkeypatch.delenv(knob, raising=False)


def _metadata(num_items):
    return dict(metadata_for_loss={'genre': np.arange(num_items) % GENRES},
                metadata_for_loss_weights={'genre': META_WEIGHT})


def _build(name, loss, meta, zoo_data, multi_stage_data):  # noqa: F811
    """``(jax_model, model)`` of ``MODELS[name]`` with ``loss``."""
    source, which, kwargs = MODELS[name]
    if source == 'zoo':
        num_items = zoo_data[4][1][0].num_items
        kwargs = dict(kwargs, **(_metadata(num_items) if meta else {}))
        return zoo_pair(which, zoo_data, K=4, loss=loss, **kwargs)
    num_items = multi_stage_data['torch'][0].num_items
    jax_model, model = multi_stage_pair('ColdStartModel', multi_stage_data, loss=loss,
                                        **(_metadata(num_items) if meta else {}))
    if which == 'no_buckets':
        jax_model.advance_stage()
        model.advance_stage()
    return jax_model, model


def _batch(model, K=4, seed=0):
    rng = np.random.default_rng(seed)
    num_users, num_items = model.hparams['num_users'], model.hparams['num_items']
    mask = np.ones(B, np.float32)
    mask[-5:] = 0.0
    return {'users': rng.integers(0, num_users, B).astype(np.int32),
            'pos_items': rng.integers(0, num_items, B).astype(np.int32),
            'neg_items': rng.integers(0, num_items, (B, K)).astype(np.int32),
            'mask': mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _selection(select_scores, loss, ideal):
    """Each row's selected index from selection scores ``[K, B]``
    (adaptive) or ``[1 + K, B]`` (WARP, the positive first), and the rows
    whose selection lies within ``NEAR_TIE`` of another: for the adaptive
    losses a best score less than ``NEAR_TIE`` above another index's (an
    exact tie, from a duplicate item or a shared bucket, is decided by the
    first-index rule in both packages), for WARP a hinge within
    ``NEAR_TIE`` of zero."""
    scores = np.asarray(select_scores, dtype=np.float64)
    if loss == 'warp':
        hinge = ideal - scores[0][:, None] + scores[1:].T          # [B, K]
        violated = hinge > 0
        idx = np.where(violated.any(axis=1), violated.argmax(axis=1), hinge.shape[1])
        return idx, np.abs(hinge).min(axis=1) < NEAR_TIE
    top2 = np.sort(scores, axis=0)[-2:]
    gap = top2[1] - top2[0]
    return scores.argmax(axis=0), (gap > 0) & (gap < NEAR_TIE)


def _ideal(batch, meta, num_items):
    if not meta:
        return 1.0
    genre = np.arange(num_items) % GENRES
    return 1.0 - META_WEIGHT * (genre[batch['pos_items']][:, None] == genre[batch['neg_items']])


@pytest.mark.parametrize('meta', [False, True], ids=['plain', 'metadata'])
@pytest.mark.parametrize('loss', ['adaptive', 'adaptive_bpr', 'warp'])
@pytest.mark.parametrize('name', list(MODELS))
def test_loss_grads_and_selection_match_jax_defaults(name, loss, meta, zoo_data,  # noqa: F811
                                                     multi_stage_data):
    jax_model, model = _build(name, loss, meta, zoo_data, multi_stage_data)
    assert model.selection_route(4) == 'sparse'
    assert model.selection_precision() == ('bf16' if name == 'mf' else 'f32')
    batch = _batch(model)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_model.calculate_loss(p, jax_batch, rng=None, training=True))(
            jax_model.params)
    leaves = {k: v.clone().requires_grad_() for k, v in model.params.items()}
    got = model.calculate_loss(leaves, _torch_batch(batch), training=True)
    grads = torch.autograd.grad(got, list(leaves.values()), allow_unused=True)

    np.testing.assert_allclose(float(got.detach()), float(ref_loss), rtol=LOSS_RTOL, atol=0)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref_grads.values())
    for (key, value), grad in zip(leaves.items(), grads):
        grad = torch.zeros_like(value) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grads[key]), rtol=0,
                                   atol=GRAD_SCALE * scale, err_msg=f'grad of {key}')

    # the selections themselves
    negs = batch['neg_items'].T
    if loss == 'warp':
        negs = np.concatenate([batch['pos_items'][None], negs])
    jax_scores = jax_model.pairwise_scores_select(jax_model.params, jax_batch['users'],
                                                  jnp.asarray(negs))
    port_scores = model.pairwise_scores_select(model.params, torch.from_numpy(
        batch['users']).long(), torch.from_numpy(negs).long())
    ideal = _ideal(batch, meta, model.hparams['num_items'])
    ref_idx, near = _selection(jax_scores, loss, ideal)
    idx, _ = _selection(port_scores.numpy(), loss, ideal)
    assert near.mean() < MAX_NEAR_TIE_SHARE, f'{near.sum()} near-tied rows of {B}'
    differ = (idx != ref_idx) & ~near
    assert not differ.any(), f'selections differ on rows {np.flatnonzero(differ)}'


# ------------------------------------------------- the port's own sparse forms

@pytest.fixture(scope='module')
def implicit_sets():
    """The data of JAX's ``implicit_sets`` fixture
    (``tests/fixtures/model_fixtures.py``) in the port."""
    inter = generate_implicit_interactions(num_users=250, num_items=500,
                                           num_interactions=20_000, seed=1)
    return collie_tpu_torch.stratified_split(inter, test_p=0.2, seed=1, force_split=True)


def _mf(train, **kwargs):
    kwargs = {'embedding_dim': 8, 'lr': 1e-1, 'loss': 'adaptive', 'seed': 0, **kwargs}
    loader = InteractionsDataLoader(interactions=train, batch_size=64, seed=0)
    return MatrixFactorizationModel(train=loader, map_location='cpu', **kwargs)


def _value_and_grads(model, batch, training=True):
    leaves = {k: v.clone().requires_grad_() for k, v in model.params.items()}
    value = model.calculate_loss(leaves, _torch_batch(batch), training=training)
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    return float(value.detach()), {k: (torch.zeros_like(v) if g is None else g)
                                   for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize('meta', [False, True], ids=['plain', 'metadata'])
@pytest.mark.parametrize('loss', ['adaptive', 'adaptive_bpr', 'warp'])
def test_sparse_forms_match_dense(implicit_sets, monkeypatch, loss, meta):
    """JAX's ``test_sparse_hardest_matches_dense``, ``_with_metadata``,
    ``test_sparse_warp_matches_dense`` and ``_with_metadata``: float32
    selection, so both forms select alike."""
    monkeypatch.setenv('COLLIE_TPU_BF16_SELECT', '0')
    train = implicit_sets[0]
    model = _mf(train, loss=loss, **(_metadata(train.num_items) if meta else {}))
    batch = _batch(model, K=5)
    v_sparse, g_sparse = _value_and_grads(model, batch)
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    v_dense, g_dense = _value_and_grads(model, batch)
    np.testing.assert_allclose(v_sparse, v_dense, rtol=1e-6)
    for k in g_dense:
        np.testing.assert_allclose(g_sparse[k].numpy(), g_dense[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _count_calls(monkeypatch, model):
    calls = {'score': 0, 'pairwise': 0, 'select': 0}
    for name, method in (('score', 'score'), ('pairwise', 'pairwise_scores'),
                         ('select', 'pairwise_scores_select')):
        original = getattr(model, method)

        def counting(*a, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(*a, **kw)
        monkeypatch.setattr(model, method, counting)
    return calls


# WARP needs K > 1 (its constructor raises at K == 1)
@pytest.mark.parametrize('case,loss', [
    (case, loss) for case in ('dropout', 'one_negative', 'eval', 'knob_off')
    for loss in ('adaptive', 'warp') if (case, loss) != ('one_negative', 'warp')])
def test_each_precondition_falls_back_to_dense(implicit_sets, monkeypatch, case, loss):
    """Dropout, ``K == 1``, ``training=False`` and
    ``COLLIE_TPU_SPARSE_ADAPTIVE=0`` each keep the dense form: the positive
    through ``score``, the negatives through one ``pairwise_scores``, no
    selection pass."""
    train = implicit_sets[0]
    K = 4
    if case == 'one_negative':
        K = 1
        train = collie_tpu_torch.Interactions(mat=train.mat, num_negative_samples=1,
                                              allow_missing_ids=True, seed=0)
    if case == 'knob_off':
        monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    if case == 'one_negative':
        with pytest.warns(UserWarning, match='standard hinge'):
            model = _mf(train, loss=loss)
    else:
        model = _mf(train, loss=loss, dropout_p=0.25 if case == 'dropout' else 0.0)
    # the route names a training step's form
    assert model.selection_route(K) == ('sparse' if case == 'eval' else 'dense')
    calls = _count_calls(monkeypatch, model)
    generator = torch.Generator().manual_seed(0) if case == 'dropout' else None
    model.calculate_loss(model.params, _torch_batch(_batch(model, K=K)),
                         generator=generator, training=case != 'eval')
    assert calls == {'score': 1, 'pairwise': 1, 'select': 0}


@pytest.mark.parametrize('loss', ['adaptive', 'adaptive_bpr', 'warp'])
def test_sparse_forms_call_structure(implicit_sets, monkeypatch, loss):
    """The sparse forms never call ``score``: one selection pass, then one
    ``pairwise_scores`` of the positive and the selected negative."""
    model = _mf(implicit_sets[0], loss=loss)
    assert model.selection_route(4) == 'sparse'
    calls = _count_calls(monkeypatch, model)
    model.calculate_loss(model.params, _torch_batch(_batch(model)), training=True)
    assert calls == {'score': 0, 'pairwise': 1, 'select': 1}


def test_adaptive_base_loss_and_routes(implicit_sets, monkeypatch):
    """JAX's ``test_sparse_hardest_preconditions``: ``hinge`` upgrades to the
    adaptive hinge at K > 1 and so takes the rewrite; WARP has no base loss
    but a sparse form of its own; the knob turns both off."""
    train = implicit_sets[0]
    assert _mf(train, dropout_p=0.25)._score_is_deterministic() is False
    assert _mf(train, loss='hinge')._adaptive_base_loss() == 'hinge'
    assert _mf(train, loss='adaptive_bpr')._adaptive_base_loss() == 'bpr'
    warp = _mf(train, loss='warp')
    assert warp._adaptive_base_loss() is None and warp.selection_route(4) == 'sparse'
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    assert _mf(train, loss='hinge')._adaptive_base_loss() is None
    assert warp.selection_route(4) == 'dense'


def test_warp_sparse_value_equals_warp_loss():
    """``warp_loss_sparse`` with a rescore that reproduces the selection
    scores equals ``warp_loss``, value and gradients, metadata included,
    with rows that never violate."""
    rng = np.random.default_rng(3)
    K, n = 5, 64
    pos = torch.tensor(rng.normal(size=n), dtype=torch.float32, requires_grad=True)
    negs = torch.tensor(rng.normal(size=(K, n)), dtype=torch.float32, requires_grad=True)
    with torch.no_grad():
        pos[:8] += 10.0                                    # no violation in K trials
    # distinct items in each column, so that an item names its score
    items = torch.as_tensor(np.stack([rng.permutation(30)[:K] for _ in range(n)], axis=1))
    pos_items = torch.as_tensor(rng.integers(0, 30, n))
    kw = dict(num_items=30, positive_items=pos_items, negative_items=items,
              metadata={'genre': torch.arange(30) % 3}, metadata_weights={'genre': 0.4},
              sample_weights=torch.ones(n))
    dense = loss_lib.warp_loss(pos, negs, **kw)
    lookup = {(int(i), int(b)): k for k in range(K) for b, i in enumerate(items[k])}

    def rescore_pair(selected):
        rows = torch.tensor([lookup[(int(i), b)] for b, i in enumerate(selected)])
        return torch.stack([pos, negs[rows, torch.arange(n)]])

    sparse = loss_lib.warp_loss_sparse(pos, negs, rescore_pair, **kw)
    assert float(sparse.detach()) == float(dense.detach())
    g_dense = torch.autograd.grad(dense, [pos, negs])
    g_sparse = torch.autograd.grad(sparse, [pos, negs])
    for a, b in zip(g_sparse, g_dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- the bfloat16 selection

def _ids(model, R=6, n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, model.hparams['num_users'], n)),
            torch.as_tensor(rng.integers(0, model.hparams['num_items'], (R, n))))


@pytest.fixture()
def trained_like_mf(implicit_sets):
    """JAX's bf16-select fixture model (``embedding_dim=8``, seed 3), with
    nonzero biases so that their rounding is seen."""
    model = _mf(implicit_sets[0], seed=3)
    params = dict(model.params)
    rng = np.random.default_rng(5)
    for key in ('user_biases', 'item_biases'):
        params[key] = torch.as_tensor(rng.normal(0, 0.3, params[key].shape),
                                      dtype=torch.float32)
    model.load_params(params)
    return model


def test_bf16_select_off_equals_f32_pairwise_exactly(trained_like_mf, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_BF16_SELECT', '0')
    users, items = _ids(trained_like_mf)
    got = trained_like_mf.pairwise_scores_select(trained_like_mf.params, users, items)
    want = trained_like_mf.pairwise_scores(trained_like_mf.params, users, items)
    assert torch.equal(got, want)


def test_bf16_select_close_to_f32(trained_like_mf):
    users, items = _ids(trained_like_mf)
    got = trained_like_mf.pairwise_scores_select(trained_like_mf.params, users, items)
    want = trained_like_mf.pairwise_scores(trained_like_mf.params, users, items).detach()
    assert not torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-2 * float(want.abs().max()))


def test_bf16_select_equals_jax_bf16_select(zoo_data):  # noqa: F811
    """The port's bfloat16 pass against JAX's on the same params and ids:
    the same roundings, so the scores agree to float32 summation order."""
    jax_model, model = zoo_pair('mf_dropout', zoo_data, dropout_p=0.0)
    users, items = _ids(model)
    got = model.pairwise_scores_select(model.params, users, items)
    want = np.asarray(jax_model.pairwise_scores_select(
        jax_model.params, jnp.asarray(users.numpy().astype(np.int32)),
        jnp.asarray(items.numpy().astype(np.int32))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_fused_and_named_layouts_select_identically(trained_like_mf):
    users, items = _ids(trained_like_mf)
    params = trained_like_mf.params
    named = trained_like_mf.pairwise_scores_select(params, users, items)
    fused = trained_like_mf.pairwise_scores_select(trained_like_mf.fuse_params(params),
                                                   users, items)
    assert torch.equal(named, fused)


def test_subclasses_and_bf16_tables_select_in_f32(implicit_sets, multi_stage_data):  # noqa: F811
    """ColdStart, a subclass of MF and an MF with bfloat16 tables take the
    float32 base pass."""
    class Sub(MatrixFactorizationModel):
        pass

    _, cold = multi_stage_pair('ColdStartModel', multi_stage_data)
    sub = Sub(train=implicit_sets[0], embedding_dim=8, seed=3, map_location='cpu')
    bf16 = _mf(implicit_sets[0], embeddings_dtype='bfloat16')
    for model in (cold, sub, bf16):
        assert model.selection_precision() == 'f32'
        users, items = _ids(model)
        got = model.pairwise_scores_select(model.params, users, items)
        assert torch.equal(got, model.pairwise_scores(model.params, users, items))


# ------------------------------------------------------------------- the fits

def _fit(model, epochs, **kwargs):
    CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=model.hparams['seed'],
                  **kwargs).fit(model)
    return model


def test_knob_flips_between_fits_take_effect(implicit_sets, monkeypatch, capsys):
    """Each fit reads the knobs anew: the selection pass runs in the first
    fit and not in the second, and the fit-start route line names each
    fit's form, precision and layout."""
    model = _mf(implicit_sets[0])
    calls = _count_calls(monkeypatch, model)
    routes = []
    for env in ({}, {'COLLIE_TPU_BF16_SELECT': '0', 'COLLIE_TPU_FUSED_TABLES': '0'},
                {'COLLIE_TPU_SPARSE_ADAPTIVE': '0'}):
        for knob, value in env.items():
            monkeypatch.setenv(knob, value)
        calls['select'] = 0
        capsys.readouterr()
        CollieTrainer(model, max_epochs=model.hparams['num_epochs_completed'] + 1,
                      verbosity=1, seed=0).fit(model)
        routes.append([line.strip() for line in capsys.readouterr().out.splitlines()
                       if line.strip().startswith('route:')])
        routes[-1].append(calls['select'] > 0)
    assert routes == [
        ['route: epoch: generic | loss: sparse, bf16 selection | tables: fused', True],
        ['route: epoch: generic | loss: sparse, f32 selection | tables: named', True],
        ['route: epoch: generic | loss: dense, f32 selection | tables: named', False]]


def test_step_path_takes_the_sparse_form_on_named_tables(implicit_sets, monkeypatch, capsys):
    """The per-step path and ``CollieMinimalTrainer`` run the new
    ``calculate_loss`` unchanged and carry the named layout, as JAX's."""
    model = _mf(implicit_sets[0])
    calls = _count_calls(monkeypatch, model)
    fuse = mock.patch.object(BasePipeline, 'fuse_params', side_effect=AssertionError('fused'))
    with fuse:
        collie_tpu_torch.CollieMinimalTrainer(model, max_epochs=1, verbosity=1, seed=0,
                                              epoch_mode='step').fit(model)
    assert 'route: epoch: per-step | loss: sparse, bf16 selection | tables: named' in \
        capsys.readouterr().out
    assert calls['select'] == calls['pairwise'] > 0 and calls['score'] == 0


def test_bf16_select_trains_to_f32_select_quality(implicit_sets, monkeypatch):
    """JAX's ``test_bf16_select_trains_to_gate_quality``: on its data and
    settings, a ``fused=False`` MF fit with the bfloat16 selection reaches
    MAP@10 above half the float32 selection's and above 0.01."""
    from collie_tpu_torch import evaluate_in_batches, mapk

    train, test = implicit_sets
    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', '0')

    def fit_map(env):
        monkeypatch.setenv('COLLIE_TPU_BF16_SELECT', env)
        model = MatrixFactorizationModel(train=train, embedding_dim=10, lr=0.1,
                                         loss='adaptive', seed=7, map_location='cpu')
        _fit(model, 6)
        return evaluate_in_batches([mapk], test, model, k=10, verbose=False)

    map_bf = fit_map('1')
    map_f32 = fit_map('0')
    assert map_bf > 0.5 * map_f32, f'bf16 selection MAP@10 {map_bf:.5f} vs f32 {map_f32:.5f}'
    assert map_bf > 0.01, f'bf16 selection failed to learn: {map_bf:.5f}'
