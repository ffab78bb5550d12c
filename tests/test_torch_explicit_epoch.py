"""The port's ``fused_mf_explicit_epoch`` (its plain version, which CPU
tensors take) against collie_tpu's Pallas kernel in interpret mode, the
explicit envelope of the port's engine, and the engine's fused explicit
epoch against the JAX engine's.

Tolerances are those of ``tests/test_torch_fused_epoch.py``: the plain
version sums duplicate-row gradients through autograd and the Pallas kernel
through one-hot matmuls, and ``torch.sigmoid`` and ``jax.nn.sigmoid`` round
differently by an ulp, so tables, biases and moments agree to ``1e-6``
absolute at these scales (0.1-scale tables, 3 steps), per-step losses to
``rtol=1e-5``, the Adam count exactly.  The engine-level epoch uses the
tolerances of ``tests/test_fused_epoch.py:92-95``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops.pallas.fused_mf_epoch import \
    fused_mf_explicit_epoch as jax_fused_mf_explicit_epoch
from collie_tpu_torch import ExplicitInteractions, InteractionsDataLoader, MatrixFactorizationModel
from collie_tpu_torch.ops.kernels.fused_mf_epoch import (MAX_DIM, fused_mf_explicit_epoch,
                                                         fused_mf_explicit_epoch_cuda,
                                                         fused_mf_explicit_epoch_plain)
from collie_tpu_torch.training import scan_engine
from collie_tpu_torch.training.scan_engine import _fused_epoch_config, build_scan_epoch_fns

NAMES = ['user_emb', 'item_emb', 'user_bias', 'item_bias', 'mu_u', 'nu_u', 'mu_i', 'nu_i']


def explicit_inputs(seed, U=30, I=50, D=8, S=3, B=16, dup=False):
    """Tables, biases, moments and an epoch of rating batches, from a numpy
    seed; the last step ends in a masked pad tail that repeats real ids."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    users = rng.integers(0, U, (S, B)).astype(np.int32)
    items = rng.integers(0, I, (S, B)).astype(np.int32)
    if dup:
        users[:, :B // 2] = users[:, :1]
        items[:, :B // 2] = items[:, :1]
    users[-1, -3:] = users[-1, 0]
    items[-1, -3:] = items[-1, 0]
    ratings = rng.integers(1, 6, (S, B)).astype(np.float32)
    mask = np.ones((S, B), np.float32)
    mask[-1, -3:] = 0.0
    return (f(U, D), f(I, D), f(U), f(I), f(U, D, scale=1e-3), np.abs(f(U, D, scale=1e-4)),
            f(I, D, scale=1e-3), np.abs(f(I, D, scale=1e-4)), np.int32(5),
            users, items, ratings, mask, np.float32(0.05), np.float32(0.01))


def _to_torch(arrays):
    tensors = [torch.from_numpy(np.array(a)) for a in arrays[:8]]
    tensors.append(torch.tensor(int(arrays[8]), dtype=torch.int32))
    tensors += [torch.from_numpy(a) for a in arrays[9:13]]
    return tensors + [float(arrays[13]), float(arrays[14])]


@pytest.mark.parametrize('loss_kind,y_range,wd,dup', [
    ('mse', None, 0.0, False),
    ('mae', None, 0.0, False),
    ('mse', (1.0, 5.0), 0.0, False),
    ('mae', (1.0, 5.0), 1e-2, True),
    ('mse', None, 1e-2, True),
    ('mse', (1.0, 5.0), 1e-2, True),
])
def test_plain_version_matches_the_pallas_kernel(loss_kind, y_range, wd, dup):
    arrays = explicit_inputs(len(loss_kind) + 3 * dup + (y_range is not None), dup=dup)
    kw = dict(loss_kind=loss_kind, y_range=y_range, wd_emb=wd, wd_bias=wd)
    ref = jax_fused_mf_explicit_epoch(*[jnp.asarray(a) for a in arrays], interpret=True, **kw)
    tensors = _to_torch(arrays)
    before = fused_mf_explicit_epoch.launches
    out = fused_mf_explicit_epoch(*tensors, **kw)
    assert fused_mf_explicit_epoch.launches == before       # CPU tensors: the plain version
    for name, a, b in zip(NAMES, out[:8], ref[:8]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
    assert int(out[8]) == int(ref[8]) == 5 + arrays[9].shape[0]
    np.testing.assert_allclose(out[9].numpy(), np.asarray(ref[9]), rtol=1e-5)
    # both biases moved, and the plain version left its inputs untouched
    assert not np.allclose(out[2].numpy(), arrays[2])
    assert not np.allclose(out[3].numpy(), arrays[3])
    np.testing.assert_array_equal(tensors[0].numpy(), arrays[0])


def test_plain_version_takes_tensor_learning_rates_and_a_live_flag():
    """As for the implicit epoch: tensor learning rates give the float epoch
    bit for bit, ``live=True`` the ordinary epoch, ``live=False`` every
    table, bias and moment as it went in with NaN losses."""
    args = _to_torch(explicit_inputs(11, dup=True))
    kw = dict(loss_kind='mse', y_range=(1.0, 5.0), wd_emb=1e-3, wd_bias=1e-3)
    ref = fused_mf_explicit_epoch_plain(*args, **kw)
    lrs = [torch.tensor(args[13], dtype=torch.float32), torch.tensor(args[14])]
    for live in (None, torch.tensor(True)):
        out = fused_mf_explicit_epoch_plain(*args[:13], *lrs, live=live, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    skipped = fused_mf_explicit_epoch_plain(*args[:13], *lrs, live=torch.tensor(False), **kw)
    for a, b in zip(skipped[:9], args[:9]):
        assert torch.equal(a, b)
    assert torch.isnan(skipped[9]).all() and int(ref[8]) == int(args[8]) + 3


def test_mae_gradient_of_an_exact_prediction_is_zero():
    """``sign(0) = 0``: an example whose prediction equals its rating gives
    no gradient, as ``jnp.sign`` in the Pallas kernel."""
    arrays = list(explicit_inputs(3, S=1, B=4))
    for table in arrays[:8]:          # zero tables, biases and moments
        table[:] = 0.0
    arrays[11] = np.array([[0.0, 0.0, 0.0, 0.0]], np.float32)   # every error exactly 0
    out = fused_mf_explicit_epoch(*_to_torch(arrays), loss_kind='mae')
    ref = jax_fused_mf_explicit_epoch(*[jnp.asarray(a) for a in arrays], loss_kind='mae',
                                      interpret=True)
    assert float(out[9][0]) == float(ref[9][0]) == 0.0
    for name, a, b in zip(NAMES, out[:4], ref[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert not a.any(), name


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tensors = _to_torch(explicit_inputs(0))
    cases = [(9, lambda t: t.long(), TypeError, 'int32'),
             (0, lambda t: t.double(), TypeError, 'float32'),
             (11, lambda t: t.long(), TypeError, 'float32'),
             (2, lambda t: t[:-1], ValueError, r'user_bias \[U\]'),
             (10, lambda t: t[:, :-1], ValueError, r'\[S, B\]'),
             (4, lambda t: t[:-1], ValueError, 'moments')]
    for index, change, error, match in cases:
        bad = list(tensors)
        bad[index] = change(bad[index])
        with pytest.raises(error, match=match):
            fused_mf_explicit_epoch(*bad)
    with pytest.raises(ValueError, match='loss_kind'):
        fused_mf_explicit_epoch(*tensors, loss_kind='hinge')
    with pytest.raises(ValueError, match='y_range'):
        fused_mf_explicit_epoch(*tensors, y_range=(1.0, 3.0, 5.0))
    with pytest.raises(ValueError, match='CUDA tensors'):
        fused_mf_explicit_epoch_cuda(*tensors)


# --------------------------------------------------------------- envelope


@pytest.fixture(scope='module')
def explicit_train():
    """The ``explicit_sets`` fixture's data (tests/fixtures/model_fixtures.py)."""
    from collie_tpu_torch import stratified_split
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(num_users=250, num_items=500, num_interactions=20_000,
                                  seed=1)
    inter = ExplicitInteractions(users=df['user_id'].values, items=df['item_id'].values,
                                 ratings=df['rating'].values, allow_missing_ids=True,
                                 num_users=250, num_items=500)
    return stratified_split(inter, test_p=0.2, seed=1, force_split=True)[0]


def _mf(loader, **kwargs):
    return MatrixFactorizationModel(train=loader, embedding_dim=kwargs.pop('embedding_dim', 8),
                                    lr=1e-2, seed=0, map_location='cpu',
                                    **{'loss': 'mse', **kwargs})


def _config_for(model):
    specs = model.optimizer_specs()
    return _fused_epoch_config(model, specs, [True] * len(specs), model.train_loader)


def test_explicit_envelope_takes_mse_mae_y_range_and_weight_decay(explicit_train):
    loader = InteractionsDataLoader(interactions=explicit_train, batch_size=1024, seed=0)
    cfg = _config_for(_mf(loader))
    assert cfg['explicit'] is True and cfg['loss_kind'] == 'mse' and cfg['y_range'] is None
    cfg = _config_for(_mf(loader, loss='mae', y_range=(1, 5), weight_decay=1e-3))
    assert cfg['loss_kind'] == 'mae' and cfg['y_range'] == (1, 5)
    assert cfg['wd_emb'] == cfg['wd_bias'] == 1e-3
    assert _config_for(_mf(loader, embedding_dim=MAX_DIM)) is not None


def test_explicit_envelope_refuses_what_the_kernel_does_not_take(explicit_train):
    loader = InteractionsDataLoader(interactions=explicit_train, batch_size=1024, seed=0)
    genre = np.random.default_rng(5).integers(0, 8, explicit_train.num_items)
    for kwargs in ({'optimizer': 'sgd'}, {'dropout_p': 0.5},
                   {'metadata_for_loss': {'genre': genre},
                    'metadata_for_loss_weights': {'genre': 0.3}},
                   {'embedding_dim': MAX_DIM + 1}, {'bias_optimizer': 'adam'}):
        assert _config_for(_mf(loader, **kwargs)) is None, kwargs
    float64 = _mf(loader)
    float64.load_params({k: v.double() for k, v in float64.params.items()})
    assert float64.params['user_biases'].dtype == torch.float64
    assert _config_for(float64) is None
    model = _mf(loader)
    specs = model.optimizer_specs()
    assert _fused_epoch_config(model, specs, [True, True], loader, mesh=object()) is None


@pytest.mark.parametrize('gate,fused', [('auto', False), ('1', True), ('0', False)])
def test_fused_epoch_knob_routes_the_explicit_epoch(explicit_train, monkeypatch, gate, fused):
    """``COLLIE_TPU_FUSED_EPOCH`` for ratings: ``auto`` takes the explicit
    kernel on ``cuda`` only (unlike JAX's auto gate, which retires it for
    TPU reasons), ``1`` its plain version here, ``0`` the generic epoch."""
    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', gate)
    loader = InteractionsDataLoader(interactions=explicit_train, batch_size=1024, seed=0)
    model = _mf(loader, y_range=(1, 5))
    fn, *_ = build_scan_epoch_fns(model, model.optimizer_specs(), [True, True], loader,
                                  shuffle=True)
    assert fn.fused is fused


def test_explicit_models_take_the_epoch_they_are_asked_for(explicit_train):
    loader = InteractionsDataLoader(interactions=explicit_train, batch_size=1024, seed=0)
    model = _mf(loader, y_range=(1, 5))
    specs = model.optimizer_specs()
    for fused, expected in ((None, False), (True, True), (False, False)):
        fn, data, S, n = build_scan_epoch_fns(model, specs, [True, True], loader,
                                              shuffle=True, fused=fused)
        assert fn.fused is expected
    assert 'ratings' in data and S == -(-n // 1024)
    batches = fn.epoch_batches(0, 1)
    assert sorted(batches) == ['items', 'mask', 'ratings', 'users']
    assert batches['ratings'].dtype == torch.float32 and batches['items'].dtype == torch.int32
    assert float(batches['mask'].sum()) == n
    outside = _mf(loader, optimizer='sgd')
    with pytest.raises(ValueError, match='envelope'):
        build_scan_epoch_fns(outside, outside.optimizer_specs(), [True, True], loader,
                             shuffle=True, fused=True)


# ------------------------------------------------------------ engine level


def jax_explicit_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items,
                       exact):
    """The JAX engine's Feistel keys for an explicit epoch, which draws
    nothing else."""
    assert sample_shape is None and not exact
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx)
    perm_rng = jax.random.split(rng, 3 if training else 2)[0]
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    return keys, None


@pytest.mark.parametrize('loss,y_range,wd', [('mse', (1.0, 5.0), 0.0), ('mae', None, 1e-3)])
def test_fused_explicit_epoch_continues_a_jax_epoch(explicit_train, monkeypatch, loss, y_range,
                                                    wd):
    """The JAX scan engine trains explicit epochs 0 and 1; its state after
    epoch 0 carries into the port (``params_from_jax``,
    ``optimizer_state_from_jax``: both tables, both biases, both optimizer
    states), whose fused epoch 1 (the plain version) must agree with JAX's."""
    from collie_tpu.data import ExplicitInteractions as JaxExplicit
    from collie_tpu.data import InteractionsDataLoader as JaxLoader
    from collie_tpu.data import stratified_split as jax_split
    from collie_tpu.data.synthetic import generate_interactions_df as jax_generate
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
    from collie_tpu.training.scan_engine import build_scan_epoch_fns as jax_build
    from collie_tpu_torch import optimizer_state_from_jax, params_from_jax

    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_explicit_draws)
    df = jax_generate(num_users=250, num_items=500, num_interactions=20_000, seed=1)
    jax_train = jax_split(JaxExplicit(users=df['user_id'].values, items=df['item_id'].values,
                                      ratings=df['rating'].values, allow_missing_ids=True,
                                      num_users=250, num_items=500),
                          test_p=0.2, seed=1, force_split=True)[0]
    common = dict(embedding_dim=8, lr=1e-2, loss=loss, y_range=y_range, seed=0,
                  weight_decay=wd)
    jax_loader = JaxLoader(interactions=jax_train, batch_size=1024, shuffle=True, seed=0)
    jax_model = JaxMF(train=jax_loader, **common)
    j_specs = jax_model.optimizer_specs()
    j_fn, j_data, S, _ = jax_build(jax_model, j_specs, [True, True], jax_loader, shuffle=True)
    params = {k: jnp.asarray(v) for k, v in jax_model.params.items()}
    states = tuple(jax.jit(s.transform.init)({k: params[k] for k in s.keys}) for s in j_specs)
    params, states, _ = j_fn(params, states, j_data, jax.random.PRNGKey(0), np.int32(0))
    start_params = {k: np.asarray(v) for k, v in params.items()}
    start_states = jax.device_get(states)
    params, states, j_loss = j_fn(params, states, j_data, jax.random.PRNGKey(0), np.int32(1))

    loader = InteractionsDataLoader(interactions=explicit_train, batch_size=1024, shuffle=True,
                                    seed=0)
    model = MatrixFactorizationModel(train=loader, map_location='cpu', **common)
    specs = model.optimizer_specs()
    fn, data, S_port, _ = build_scan_epoch_fns(model, specs, [True, True], loader,
                                               shuffle=True, fused=True)
    assert S_port == S and fn.fused
    t_params = params_from_jax(start_params, 'cpu')
    t_states = tuple(optimizer_state_from_jax(s, 'cpu') for s in start_states)
    assert sorted(t_params) == sorted(start_params)
    np.testing.assert_array_equal(t_params['user_biases'].numpy(), start_params['user_biases'])
    assert np.abs(start_params['user_biases']).max() > 1e-4       # epoch 0 moved them
    t_params, t_states, t_loss = fn(t_params, t_states, data, 0, 1)

    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    for k, ref in params.items():
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(t_params[k].numpy(), ref, atol=5e-4 * scale, rtol=0,
                                   err_msg=k)
    carried = tuple(optimizer_state_from_jax(s, 'cpu') for s in jax.device_get(states))
    for got, ref in zip(t_states, carried):
        assert got.count == ref.count == 2 * S
        assert got.learning_rate == ref.learning_rate
    assert int(t_states[0].adam_count) == int(carried[0].adam_count) == 2 * S
    for k in ('user_embeddings', 'item_embeddings'):
        for got, ref in ((t_states[0].mu[k], carried[0].mu[k]),
                         (t_states[0].nu[k], carried[0].nu[k])):
            scale = max(float(ref.abs().max()), 1e-6)
            torch.testing.assert_close(got, ref, rtol=0, atol=5e-4 * scale)
