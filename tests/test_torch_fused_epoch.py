"""The port's ``fused_mf_epoch`` (its plain version, which CPU tensors take)
against collie_tpu's Pallas kernel in interpret mode, the port's envelope
against ``tests/test_fused_epoch.py:328-430``, and the engine's fused epoch
against the JAX engine's.

Tolerances: the plain version sums duplicate-row gradients through autograd
and the Pallas kernel through one-hot matmuls, so tables and moments agree
to ``1e-6`` absolute at these scales (0.1-scale tables, 3 steps), per-step
losses to ``rtol=1e-5``, the Adam count exactly.  Engine-level epochs use
the tolerances of ``tests/test_fused_epoch.py:92-95``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops.pallas.fused_mf_epoch import fused_mf_epoch as jax_fused_mf_epoch
from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel
from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch, fused_mf_epoch_cuda
from collie_tpu_torch.training import scan_engine
from collie_tpu_torch.training.scan_engine import _fused_epoch_config, build_scan_epoch_fns


def epoch_inputs(seed, U=30, I=50, D=8, S=3, B=16, K=4, F=0, dup=False):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    users = rng.integers(0, U, (S, B)).astype(np.int32)
    pos = rng.integers(0, I, (S, B)).astype(np.int32)
    negs = rng.integers(0, I, (S, B, K)).astype(np.int32)
    if dup:
        users[:, :B // 2] = users[:, :1]
        pos[:, :B // 2] = pos[:, :1]
    mask = np.ones((S, B), np.float32)
    mask[-1, -3:] = 0.0
    arrays = (f(U, D), f(I, D), f(I), f(U, D, scale=1e-3), np.abs(f(U, D, scale=1e-4)),
              f(I, D, scale=1e-3), np.abs(f(I, D, scale=1e-4)), np.int32(5),
              users, pos, negs, mask, np.float32(0.05), np.float32(0.01))
    meta = rng.integers(0, 3, (F, I)).astype(np.int32) if F else None
    return arrays, meta


def _to_torch(arrays, meta):
    tensors = [torch.from_numpy(np.array(a)) for a in arrays[:7]]
    tensors.append(torch.tensor(int(arrays[7]), dtype=torch.int32))
    tensors += [torch.from_numpy(a) for a in arrays[8:12]]
    tensors += [float(arrays[12]), float(arrays[13])]
    return tensors, (torch.from_numpy(meta) if meta is not None else None)


VARIANTS = [('hinge', False, 1), ('hinge', True, 4), ('bpr', False, 4), ('bpr', True, 4),
            ('warp', False, 5)]


@pytest.mark.parametrize('loss_kind,adaptive,K', VARIANTS)
@pytest.mark.parametrize('meta_wd_dup', [False, True])
def test_plain_version_matches_the_pallas_kernel(loss_kind, adaptive, K, meta_wd_dup):
    F, wd = (2, 1e-2) if meta_wd_dup else (0, 0.0)
    arrays, meta = epoch_inputs(K + 7 * adaptive, K=K, F=F, dup=meta_wd_dup)
    kw = dict(K=K, adaptive=adaptive, loss_kind=loss_kind, meta_weights=(0.25, 0.15)[:F],
              wd_emb=wd, wd_bias=wd)
    ref = jax_fused_mf_epoch(*[jnp.asarray(a) for a in arrays],
                             jnp.asarray(meta) if F else None, interpret=True, **kw)
    tensors, t_meta = _to_torch(arrays, meta)
    before = fused_mf_epoch.launches
    out = fused_mf_epoch(*tensors, t_meta, **kw)
    assert fused_mf_epoch.launches == before       # CPU tensors: the plain version
    for name, a, b in zip(['user_emb', 'item_emb', 'item_bias', 'mu_u', 'nu_u', 'mu_i', 'nu_i'],
                          out[:7], ref[:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
    assert int(out[7]) == int(ref[7]) == 5 + arrays[8].shape[0]
    np.testing.assert_allclose(out[8].numpy(), np.asarray(ref[8]), rtol=1e-5)
    # the plain version returns new tensors: the inputs are untouched
    np.testing.assert_array_equal(tensors[0].numpy(), arrays[0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    arrays, _ = epoch_inputs(0)
    tensors, _ = _to_torch(arrays, None)
    kw = dict(K=4, adaptive=True, loss_kind='hinge')
    bad = list(tensors)
    bad[8] = bad[8].long()
    with pytest.raises(TypeError, match='int32'):
        fused_mf_epoch(*bad, None, **kw)
    bad = list(tensors)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError, match='float32'):
        fused_mf_epoch(*bad, None, **kw)
    with pytest.raises(ValueError, match=r'negs must be \[S, B, K\]'):
        fused_mf_epoch(*tensors, None, **{**kw, 'K': 3})
    with pytest.raises(ValueError, match='loss_kind'):
        fused_mf_epoch(*tensors, None, **{**kw, 'loss_kind': 'mse'})
    with pytest.raises(ValueError, match='meta_rows'):
        fused_mf_epoch(*tensors, None, **{**kw, 'meta_weights': (0.5,)})
    with pytest.raises(ValueError, match='CUDA tensors'):
        fused_mf_epoch_cuda(*tensors, None, **kw)


def test_kernel_scratch_is_zeroed_aligned_and_disjoint():
    """The accumulators the persistent kernel streams as float4, the losses
    (none when S = 0) and the barrier word come from one zeroed allocation,
    each on a 16-byte boundary, none overlapping."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import _zeroed

    shapes = [(37, 10), (53, 10), (53,), (0,), (1,)]
    parts = _zeroed('cpu', *shapes)
    assert [tuple(p.shape) for p in parts] == shapes
    starts = [p.storage_offset() for p in parts]
    assert all(a % 4 == 0 for a in starts)
    assert all(a + p.numel() <= b for a, p, b in zip(starts, parts, starts[1:]))
    assert all(p.untyped_storage().data_ptr() == parts[0].untyped_storage().data_ptr()
               for p in parts)
    assert all(not p.any() for p in parts)


def test_timeline_must_hold_two_stamps_a_step_and_one():
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import _timeline_ptr

    device = torch.device('cpu')
    assert _timeline_ptr(None, 3, device) is None
    good = torch.zeros(7, dtype=torch.int64)
    assert _timeline_ptr(good, 3, device) == good.data_ptr()
    for bad in (torch.zeros(6, dtype=torch.int64), torch.zeros(7, dtype=torch.int32),
                torch.zeros(14, dtype=torch.int64)[::2]):
        with pytest.raises(ValueError, match='timeline'):
            _timeline_ptr(bad, 3, device)


@pytest.mark.parametrize('loss_kind,adaptive,K', VARIANTS[:3])
def test_plain_version_takes_tensor_learning_rates_and_a_live_flag(loss_kind, adaptive, K):
    """The learning rates as 0-d tensors give the float epoch bit for bit;
    ``live=True`` is the ordinary epoch; ``live=False`` is a skipped one:
    every table and moment as it went in, the count unchanged, NaN losses."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch_plain

    arrays, meta = epoch_inputs(7 + K, K=K, F=1, dup=True)
    args, meta = _to_torch(arrays, meta)
    kw = dict(K=K, adaptive=adaptive, loss_kind=loss_kind, meta_weights=(0.5,),
              wd_emb=1e-3, wd_bias=1e-3)
    ref = fused_mf_epoch_plain(*args, meta, **kw)
    lrs = [torch.tensor(args[12], dtype=torch.float32), torch.tensor(args[13])]
    for live in (None, torch.tensor(True), torch.tensor(1, dtype=torch.int32)):
        out = fused_mf_epoch_plain(*args[:12], *lrs, meta, live=live, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    skipped = fused_mf_epoch_plain(*args[:12], *lrs, meta, live=torch.tensor(False), **kw)
    for a, b in zip(skipped[:8], args[:8]):
        assert torch.equal(a, b)
    assert torch.isnan(skipped[8]).all() and int(ref[7]) == int(args[7]) + 3
    # the wrapper takes the same arguments to the same plain version on the CPU
    wrapped = fused_mf_epoch(*args[:12], *lrs, meta, live=torch.tensor(False), **kw)
    for a, b in zip(wrapped, skipped):
        assert torch.equal(a, b) or (torch.isnan(a).all() and torch.isnan(b).all())


def test_wrapper_rejects_a_live_flag_of_several_values():
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch_plain

    args, _ = _to_torch(*epoch_inputs(0))
    with pytest.raises(ValueError, match='live'):
        fused_mf_epoch_plain(*args, K=4, adaptive=True, live=torch.ones(2, dtype=torch.bool))


# --------------------------------------------------------------- envelope


@pytest.fixture(scope='module')
def train():
    from collie_tpu_torch import stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions

    inter = generate_implicit_interactions(num_users=250, num_items=500,
                                           num_interactions=20_000, seed=1)
    return stratified_split(inter, test_p=0.2, seed=1, force_split=True)[0]


def _config_for(model, loader, mesh=None):
    specs = model.optimizer_specs()
    return _fused_epoch_config(model, specs, [True] * len(specs), loader, mesh)


def _mf(loader, **kwargs):
    return MatrixFactorizationModel(train=loader, embedding_dim=kwargs.pop('embedding_dim', 8),
                                    lr=1e-1, seed=0, map_location='cpu', **kwargs)


def test_envelope_accepts_default_mf_warp_and_weight_decay(train):
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, seed=0)
    cfg = _config_for(_mf(loader, loss='adaptive'), loader)
    assert cfg is not None and cfg['adaptive'] is True and cfg['loss_kind'] == 'hinge'
    assert _config_for(_mf(loader, loss='hinge'), loader) is not None
    warp = _config_for(_mf(loader, loss='warp'), loader)
    assert warp is not None and warp['loss_kind'] == 'warp'
    wd = _config_for(_mf(loader, loss='adaptive', weight_decay=1e-4), loader)
    assert wd is not None and wd['wd_emb'] == 1e-4 and wd['wd_bias'] == 1e-4
    sparse = _config_for(_mf(loader, optimizer='sparse_adam', weight_decay=1e-4), loader)
    assert sparse is not None and sparse['wd_emb'] == 0.0 and sparse['wd_bias'] == 1e-4


def test_envelope_rejects_out_of_scope(train):
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, seed=0)
    for kwargs in ({'dropout_p': 0.5}, {'y_range': (0.0, 5.0)}, {'optimizer': 'sgd'},
                   {'bias_optimizer': 'adam'}, {'bias_optimizer': None},
                   {'embeddings_dtype': 'bfloat16'},
                   {'embedding_dim': 257}):        # the CUDA kernel's MAX_DIM is 256
        assert _config_for(_mf(loader, **kwargs), loader) is None, kwargs
    assert _config_for(_mf(loader, embedding_dim=256), loader) is not None
    assert _config_for(_mf(loader, loss='adaptive'), loader, mesh=object()) is None


def test_envelope_takes_explicit_data_through_the_explicit_kernel():
    """Explicit data takes the explicit twin kernel, which the JAX auto gate
    retires for TPU reasons only: an MSE MF with ``y_range`` is inside the
    envelope (``y_range`` is outside it for implicit data), an implicit loss
    is not, and the engine builds its epoch."""
    from collie_tpu_torch import ExplicitInteractions

    rng = np.random.default_rng(0)
    inter = ExplicitInteractions(users=rng.integers(0, 20, 200), items=rng.integers(0, 30, 200),
                                 ratings=rng.integers(1, 6, 200), allow_missing_ids=True,
                                 num_users=20, num_items=30)
    loader = InteractionsDataLoader(interactions=inter, batch_size=64, seed=0)
    model = _mf(loader, loss='mse', y_range=(1, 5))
    cfg = _config_for(model, loader)
    assert cfg is not None and cfg['explicit'] is True
    assert (cfg['loss_kind'], cfg['adaptive'], cfg['y_range']) == ('mse', False, (1, 5))
    fn, data, S, n = build_scan_epoch_fns(model, model.optimizer_specs(), [True, True], loader,
                                          shuffle=True, fused=True)
    assert fn.fused is True and S == -(-n // 64) and 'ratings' in data


def test_envelope_metadata_gating(train):
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, seed=0)
    good = {'genre': np.random.default_rng(5).integers(0, 8, train.num_items)}
    cfg = _config_for(_mf(loader, loss='adaptive', metadata_for_loss=good,
                          metadata_for_loss_weights={'genre': 0.3}), loader)
    assert cfg is not None and cfg['meta_names'] == ('genre',)
    for metadata, weights in ((good, {'genre': 1.5}),
                              ({'genre': good['genre'].astype(np.float32)}, {'genre': 0.3}),
                              ({'genre': good['genre'][:-1]}, {'genre': 0.3}),
                              (good, None)):
        m = _mf(loader, loss='adaptive', metadata_for_loss=metadata,
                metadata_for_loss_weights=weights)
        assert _config_for(m, loader) is None, (metadata, weights)


def test_cpu_models_take_the_generic_epoch_unless_asked(train):
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, seed=0)
    model = _mf(loader, loss='adaptive')
    specs = model.optimizer_specs()
    fn, *_ = build_scan_epoch_fns(model, specs, [True, True], loader, shuffle=True)
    assert fn.fused is False
    fn, *_ = build_scan_epoch_fns(model, specs, [True, True], loader, shuffle=True, fused=True)
    assert fn.fused is True
    # fused=False: the generic epoch on any device, the JAX package's
    # COLLIE_TPU_FUSED_EPOCH=0
    fn, *_ = build_scan_epoch_fns(model, specs, [True, True], loader, shuffle=True, fused=False)
    assert fn.fused is False
    outside = _mf(loader, loss='adaptive', optimizer='sgd')
    with pytest.raises(ValueError, match='envelope'):
        build_scan_epoch_fns(outside, outside.optimizer_specs(), [True, True], loader,
                             shuffle=True, fused=True)


@pytest.mark.parametrize('gate,fused', [('auto', False), ('1', True), ('0', False)])
def test_fused_epoch_knob_routes_the_trainers_epoch(train, monkeypatch, gate, fused):
    """``COLLIE_TPU_FUSED_EPOCH`` maps onto ``fused=None``: ``auto`` takes
    the kernel on ``cuda`` only (the CPU here: the generic epoch), ``1`` the
    fused function on any device (its plain version), ``0`` the generic
    epoch; outside the envelope ``1`` falls to the generic epoch, as JAX's
    gate does.  An explicit ``fused=`` argument overrides the knob."""
    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', gate)
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, seed=0)
    model = _mf(loader, loss='adaptive')
    specs = model.optimizer_specs()
    fn, *_ = build_scan_epoch_fns(model, specs, [True, True], loader, shuffle=True)
    assert fn.fused is fused
    outside = _mf(loader, loss='adaptive', optimizer='sgd')
    fn, *_ = build_scan_epoch_fns(outside, outside.optimizer_specs(), [True, True], loader,
                                  shuffle=True)
    assert fn.fused is False
    for explicit_arg in (True, False):
        fn, *_ = build_scan_epoch_fns(model, specs, [True, True], loader, shuffle=True,
                                      fused=explicit_arg)
        assert fn.fused is explicit_arg


# ------------------------------------------------------------ engine level


def _jax_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items, exact):
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch_idx)
    perm_rng, sample_rng, _ = jax.random.split(rng, 3)
    keys = None
    if perm_n:
        keys = torch.from_numpy(np.asarray(jax.random.randint(
            perm_rng, (4,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)).astype(np.int64))
    return keys, torch.from_numpy(np.array(jax.random.uniform(sample_rng, sample_shape)))


@pytest.mark.parametrize('loss,wd', [('adaptive', 0.0), ('bpr', 1e-3)])
def test_fused_engine_epoch_continues_a_jax_epoch(train, monkeypatch, loss, wd):
    """JAX's fused engine trains epoch 0; its params and optax state carry
    into the port (``params_from_jax``, ``optimizer_state_from_jax``), and
    epoch 1 of both engines must agree — perturbed user biases included,
    whose weight decay is the engine's closed form."""
    from collie_tpu.data import InteractionsDataLoader as JaxLoader
    from collie_tpu.data import stratified_split as jax_split
    from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
    from collie_tpu.training.scan_engine import build_scan_epoch_fns as jax_build
    from collie_tpu_torch import optimizer_state_from_jax, params_from_jax

    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', '1')
    monkeypatch.setattr(scan_engine, 'draw_epoch', _jax_draws)
    jax_train = jax_split(jax_generate(num_users=250, num_items=500, num_interactions=20_000,
                                       seed=1), test_p=0.2, seed=1, force_split=True)[0]
    jax_loader = JaxLoader(interactions=jax_train, batch_size=1024, shuffle=True, seed=0)
    jax_model = JaxMF(train=jax_loader, embedding_dim=8, lr=1e-1, loss=loss, seed=0,
                      weight_decay=wd)
    user_biases = np.random.default_rng(9).normal(0, 0.1, 250).astype(np.float32)
    jax_model.params['user_biases'] = jnp.asarray(user_biases)
    j_specs = jax_model.optimizer_specs()
    j_fn, j_data, S, _ = jax_build(jax_model, j_specs, [True, True], jax_loader, shuffle=True)
    params = {k: jnp.asarray(v) for k, v in jax_model.params.items()}
    states = tuple(jax.jit(s.transform.init)({k: params[k] for k in s.keys}) for s in j_specs)
    params, states, _ = j_fn(params, states, j_data, jax.random.PRNGKey(0), np.int32(0))
    start_params = {k: np.asarray(v) for k, v in params.items()}
    start_states = jax.device_get(states)
    params, states, j_loss = j_fn(params, states, j_data, jax.random.PRNGKey(0), np.int32(1))

    loader = InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True, seed=0)
    model = _mf(loader, loss=loss, weight_decay=wd)
    specs = model.optimizer_specs()
    fn, data, S_port, _ = build_scan_epoch_fns(model, specs, [True, True], loader,
                                               shuffle=True, fused=True)
    assert S_port == S
    t_params = params_from_jax(start_params, 'cpu')
    t_states = tuple(optimizer_state_from_jax(s, 'cpu') for s in start_states)
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
        scale = max(float(carried[0].mu[k].abs().max()), 1e-6)
        torch.testing.assert_close(t_states[0].mu[k], carried[0].mu[k], rtol=0,
                                   atol=5e-4 * scale)
