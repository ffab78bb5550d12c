"""The whole fit (``CollieTrainer._run_fit_scan`` over
``scan_engine.build_scan_fit_fn``): the device schedulers, early stopping
and the NaN trip replicate the per-epoch loop, as in ``tests/test_whole_fit.
py``, and the port's whole fit holds to collie_tpu's.

Against the per-epoch loop (``COLLIE_TPU_WHOLE_FIT=0``): both run the same
epoch functions with the same draws, on one CPU thread (several threads
scatter-add duplicate rows' gradients in a run-dependent order), so params
agree within ``atol=1e-6`` (bit for bit in practice), and the learning
rates, ``ran`` mask, best epoch and epochs completed are equal.

Against JAX's whole fit: the same initial params (``params_from_jax``),
JAX's epoch draws (``tests/test_torch_training.py``'s ``jax_epoch_draws``),
JAX on its dense adaptive branch.  Per-epoch losses agree within rtol 1e-4
and params within ``5e-4 * max|param|`` (``tests/test_torch_training.py``'s
tolerances); the learning rates, the ``ran`` mask and the absorbed
scheduler state's counter are equal, its best loss within rtol 1e-4.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from collie_tpu_torch import (CollieTrainer, InteractionsDataLoader, MatrixFactorizationModel,
                              ReduceLROnPlateau, StepLR, params_from_jax, stratified_split)
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.ops import shuffle
from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch_plain,
                                                         fused_mf_explicit_epoch_plain)
from collie_tpu_torch.training import scan_engine
from collie_tpu_torch.training import trainer as trainer_module

from tests.test_torch_training import data_pair, jax_epoch_draws  # noqa: F401

SMALL = dict(num_users=100, num_items=200, num_interactions=4000, seed=3)
BATCH = 512
#: Tensor methods that read a value back to the host (on the card: a sync)
HOST_READS = ('__bool__', 'item', '__float__', '__int__', '__index__', 'tolist', 'numpy',
              'cpu')


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def small_sets():
    return stratified_split(generate_implicit_interactions(**SMALL), test_p=0.2, seed=1,
                            force_split=True)


class FitRecorder:
    """Wraps ``build_scan_fit_fn`` (of either package) and keeps every
    block's ``(train_losses, val_losses, lrs, ran)`` and the last scheduler
    state, as numpy."""

    def __init__(self, module, monkeypatch):
        self.blocks, self.sched = [], None
        build = module.build_scan_fit_fn

        def recording(*args, **kwargs):
            fn = build(*args, **kwargs)

            def fit_fn(*a, **k):
                out = fn(*a, **k)
                host = lambda t: np.asarray(t.detach() if torch.is_tensor(t) else t)  # noqa: E731
                self.blocks.append((host(out[4]), host(out[5]), [host(x) for x in out[6]],
                                    host(out[7])))
                self.sched = [tuple(host(x) for x in st) for st in out[2]]
                return out
            return fit_fn

        monkeypatch.setattr(module, 'build_scan_fit_fn', recording)

    def trace(self, i):
        return np.concatenate([b[i] for b in self.blocks]) if self.blocks else np.zeros(0)

    def lrs(self, spec):
        return np.concatenate([b[2][spec] for b in self.blocks])


def _fit(train, monkeypatch, whole_fit, *, epochs=6, lr=1e-1, patience=None, nan_guard=False,
         scheduler='default', val=None, logger=None, verbosity=0, **model_kwargs):
    monkeypatch.setenv('COLLIE_TPU_WHOLE_FIT', '1' if whole_fit else '0')
    kwargs = dict(model_kwargs)
    if scheduler != 'default':
        kwargs['lr_scheduler_func'] = scheduler
    model = MatrixFactorizationModel(
        train=InteractionsDataLoader(train, batch_size=BATCH, shuffle=True, seed=0),
        val=None if val is None else InteractionsDataLoader(val, batch_size=BATCH, seed=0),
        embedding_dim=8, lr=lr, loss='adaptive', seed=0, map_location='cpu', **kwargs)
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=verbosity, seed=0,
                            early_stopping_patience=patience, terminate_on_nan=nan_guard,
                            logger=logger, enable_model_summary=False)
    trainer.fit(model)
    return {k: v.detach().numpy().copy() for k, v in model.params.items()}, trainer, model


def _assert_same_fit(a, b):
    (p1, t1, m1), (p0, t0, m0) = a, b
    for k in p0:
        np.testing.assert_allclose(p1[k], p0[k], rtol=0, atol=1e-6, err_msg=f'param {k}')
    assert m1.hparams['num_epochs_completed'] == m0.hparams['num_epochs_completed']
    assert t1.num_epochs_completed == t0.num_epochs_completed
    assert t1.best_epoch_loss[0] == t0.best_epoch_loss[0]
    np.testing.assert_allclose(t1.best_epoch_loss[1], t0.best_epoch_loss[1], rtol=1e-6)


class _Lrs:
    """Every learning rate the per-epoch loop sets (``set_lr``)."""

    def __init__(self, monkeypatch):
        self.values = []
        real = trainer_module.set_lr

        def recording(state, lr):
            self.values.append(lr)
            return real(state, lr)
        monkeypatch.setattr(trainer_module, 'set_lr', recording)


def test_whole_fit_is_the_default_and_matches_per_epoch_loop(small_sets, monkeypatch):
    rec = FitRecorder(trainer_module, monkeypatch)
    whole = _fit(small_sets[0], monkeypatch, True)
    assert len(rec.trace(0)) == 6 and rec.trace(3).all()
    monkeypatch.delenv('COLLIE_TPU_WHOLE_FIT')
    default = _fit(small_sets[0], monkeypatch, True)
    _assert_same_fit(whole, default)
    per_epoch = _fit(small_sets[0], monkeypatch, False)
    assert len(rec.blocks) == 4                  # blocks 4 + 2, twice; none per epoch
    _assert_same_fit(whole, per_epoch)
    assert whole[2].hparams['num_epochs_completed'] == 6


PLATEAU_EVERY_EPOCH = ReduceLROnPlateau(factor=0.3, patience=0, threshold=0.5)


@pytest.mark.parametrize('scheduler', ['default', PLATEAU_EVERY_EPOCH, StepLR(2, 0.3)],
                         ids=['default-plateau', 'plateau-every-epoch', 'steplr'])
def test_whole_fit_lr_trajectory_equals_per_epoch_loop(small_sets, monkeypatch, capsys,
                                                       scheduler):
    """The learning rates the device steps reach are the per-epoch loop's,
    value for value (both in float32), and print the same lines."""
    rec = FitRecorder(trainer_module, monkeypatch)
    capsys.readouterr()
    whole = _fit(small_sets[0], monkeypatch, True, epochs=10, scheduler=scheduler,
                 verbosity=1)
    lines1 = [ln.strip() for ln in capsys.readouterr().out.splitlines() if 'lr[' in ln]
    lrs = _Lrs(monkeypatch)
    per_epoch = _fit(small_sets[0], monkeypatch, False, epochs=10, scheduler=scheduler,
                     verbosity=1)
    lines0 = [ln.strip() for ln in capsys.readouterr().out.splitlines() if 'lr[' in ln]
    _assert_same_fit(whole, per_epoch)
    assert lines1 == lines0
    device_changes = []
    for spec, initial in enumerate((0.1, 1e-2)):                # lr, bias_lr
        trace = np.r_[np.float32(initial), rec.lrs(spec)]
        device_changes += [float(v) for v, prev in zip(trace[1:], trace[:-1]) if v != prev]
    assert sorted(device_changes) == sorted(lrs.values)
    if not isinstance(scheduler, str):
        assert len(lrs.values) >= 4 and all(v > 0 for v in lrs.values)


def test_whole_fit_scheduler_state_is_absorbed(small_sets, monkeypatch):
    """The host scheduler objects end in the per-epoch loop's state, so a
    later fit or checkpoint continues them."""
    schedulers = []
    real = trainer_module.resolve_scheduler

    def keep(func):
        schedulers.append(real(func))
        return schedulers[-1]
    monkeypatch.setattr(trainer_module, 'resolve_scheduler', keep)
    for whole_fit in (True, False):
        _fit(small_sets[0], monkeypatch, whole_fit, epochs=5,
             scheduler=ReduceLROnPlateau(factor=0.5, patience=1))
    first, second = schedulers[:2], schedulers[2:]
    assert [vars(s) for s in first] == [vars(s) for s in second]
    assert all(s.best is not None for s in first)


def test_whole_fit_early_stopping(small_sets, monkeypatch):
    """Zero learning rates freeze the params while the epoch loss varies
    with the draws: both loops stop at the same epoch with the same best."""
    kw = dict(epochs=20, lr=0.0, bias_lr=0.0, patience=2, scheduler=None)
    whole = _fit(small_sets[0], monkeypatch, True, **kw)
    per_epoch = _fit(small_sets[0], monkeypatch, False, **kw)
    assert whole[2].hparams['num_epochs_completed'] < 20
    _assert_same_fit(whole, per_epoch)


def test_whole_fit_early_stopping_across_flights(small_sets, monkeypatch, capsys):
    """120 epochs are blocks [16 x 7, 8]: two flights of 4 blocks.  A stop
    in the first flight leaves its later epochs skipped (``ran`` false,
    NaN losses) and dispatches no second flight; the replay reports the
    per-epoch loop's stop epoch, best and message."""
    rec = FitRecorder(trainer_module, monkeypatch)
    kw = dict(epochs=120, lr=0.0, bias_lr=0.0, patience=2, scheduler=None, verbosity=1)
    capsys.readouterr()
    whole = _fit(small_sets[0], monkeypatch, True, **kw)
    out1 = capsys.readouterr().out
    per_epoch = _fit(small_sets[0], monkeypatch, False, **kw)
    out0 = capsys.readouterr().out
    _assert_same_fit(whole, per_epoch)
    stop = whole[2].hparams['num_epochs_completed']
    assert stop < 64
    ran = rec.trace(3)
    assert len(rec.blocks) == 4 and len(ran) == 64           # one flight
    assert ran[:stop].all() and not ran[stop:].any()
    assert np.isnan(rec.trace(0)[stop:]).all() and np.isfinite(rec.trace(0)[:stop]).all()
    assert [e['epoch'] for e in whole[1].epoch_log] == list(range(1, stop + 1))
    stop_line = [ln for ln in out0.splitlines() if ln.startswith('Early stopping')]
    assert stop_line and stop_line == [ln for ln in out1.splitlines()
                                       if ln.startswith('Early stopping')]


def test_whole_fit_skipped_epochs_leave_state_bit_identical(small_sets, monkeypatch):
    """After the stop, the skipped epochs change no param and no optimizer
    state leaf: the final state is the stop epoch's, bit for bit."""
    states = []
    build = scan_engine.build_scan_epoch_fns

    def recording(*args, **kwargs):
        fn, *rest = build(*args, **kwargs)
        if not kwargs.get('training', True):
            return (fn, *rest)

        def epoch_fn(params, opt_states, data, seed, epoch, live=None):
            out = fn(params, opt_states, data, seed, epoch, live)
            states.append((out, live))
            return out
        epoch_fn.split_ms = fn.split_ms
        return (epoch_fn, *rest)
    monkeypatch.setattr(trainer_module, 'build_scan_epoch_fns', recording)
    params, trainer, _ = _fit(small_sets[0], monkeypatch, True, epochs=40, lr=1e-2,
                              patience=0, scheduler=None)
    stop = trainer.num_epochs_completed
    assert stop < 40 and len(states) == 40          # blocks 16 + 16 + 8: one flight
    (stop_params, stop_states, _), _ = states[stop - 1]
    for (p, s, loss), live in states[stop:]:
        assert not bool(live) and torch.isnan(loss)
        for k, v in p.items():
            assert torch.equal(v, stop_params[k]), k
        for new, old in zip(s, stop_states):
            leaves = zip(scan_engine.state_leaves(new), scan_engine.state_leaves(old))
            assert all(torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in leaves)
    for k, v in params.items():
        np.testing.assert_array_equal(v, stop_params[k].numpy())


def test_whole_fit_patience_zero_improving_run_completes(small_sets, monkeypatch):
    kw = dict(epochs=4, patience=0, scheduler=None, lr=1e-2)
    whole = _fit(small_sets[0], monkeypatch, True, **kw)
    per_epoch = _fit(small_sets[0], monkeypatch, False, **kw)
    _assert_same_fit(whole, per_epoch)
    assert whole[2].hparams['num_epochs_completed'] >= 2


@pytest.mark.parametrize('whole_fit', [True, False])
def test_whole_fit_nan_guard(small_sets, monkeypatch, whole_fit):
    """A divergent learning rate raises ``FloatingPointError`` before the
    NaN epoch counts as completed, from both loops."""
    with pytest.raises(FloatingPointError, match='NaN/Inf train loss at epoch'):
        _fit(small_sets[0], monkeypatch, whole_fit, epochs=10, lr=1e18, nan_guard=True,
             scheduler=None)


def test_whole_fit_with_validation(small_sets, monkeypatch):
    """Validation monitoring: both loops step the plateau scheduler and
    early stopping on the val loss."""
    train, val = small_sets
    kw = dict(val=val, epochs=5, scheduler=ReduceLROnPlateau(factor=0.5, patience=0),
              patience=3)
    rec = FitRecorder(trainer_module, monkeypatch)
    whole = _fit(train, monkeypatch, True, **kw)
    per_epoch = _fit(train, monkeypatch, False, **kw)
    _assert_same_fit(whole, per_epoch)
    assert np.isfinite(rec.trace(1)[rec.trace(3)]).all()


def test_whole_fit_logger_replay(small_sets, monkeypatch):
    """Logger rows are replayed after each flight, in epoch order, with the
    per-epoch loop's values; ``epoch_log`` keeps every epoch's split."""
    class Rec:
        def __init__(self):
            self.rows = []

        def log_metrics(self, metrics, step=None):
            self.rows.append((step, dict(metrics)))

    logs = Rec(), Rec()
    _, trainer, _ = _fit(small_sets[0], monkeypatch, True, epochs=3, logger=logs[0])
    _fit(small_sets[0], monkeypatch, False, epochs=3, logger=logs[1])
    assert [r[0] for r in logs[0].rows] == [1, 2, 3]
    assert logs[0].rows == logs[1].rows
    assert [e['epoch'] for e in trainer.epoch_log] == [1, 2, 3]
    assert all(e['seconds'] > 0 and e['shuffle_ms'] > 0 and e['train_ms'] > 0
               for e in trainer.epoch_log)
    assert trainer.last_fit_examples_per_sec > 0


def test_whole_fit_repeat_fit_continues_epochs(small_sets, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_WHOLE_FIT', '1')
    model = MatrixFactorizationModel(train=small_sets[0], embedding_dim=8, lr=1e-1, seed=0,
                                     map_location='cpu')
    trainer = CollieTrainer(model, max_epochs=1, verbosity=0, seed=0)
    trainer.fit(model)
    assert model.hparams['num_epochs_completed'] == 1
    trainer.max_epochs = 4
    trainer.fit(model)
    assert model.hparams['num_epochs_completed'] == 4
    assert [e['epoch'] for e in trainer.epoch_log] == [2, 3, 4]
    trainer.fit(model)                               # nothing left to run
    assert model.hparams['num_epochs_completed'] == 4


class MomentumSGD:
    """A custom transform whose state keeps no ``learning_rate``."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, state, params):
        trace = {k: grads[k] + 0.9 * state[k] for k in grads}
        return {k: -self.learning_rate * t for k, t in trace.items()}, trace


@pytest.mark.parametrize('scheduler', ['default', None])
def test_custom_factory_under_a_scheduler_takes_the_per_epoch_loop(small_sets, monkeypatch,
                                                                   scheduler):
    """A scheduler on a state without ``learning_rate`` routes the fit to
    the per-epoch loop (JAX's rule); without a scheduler the same factory
    runs the whole fit."""
    rec = FitRecorder(trainer_module, monkeypatch)
    _, trainer, model = _fit(small_sets[0], monkeypatch, True, epochs=2, scheduler=scheduler,
                             optimizer=lambda learning_rate, **kw: MomentumSGD(learning_rate),
                             bias_optimizer=None)
    assert model.hparams['num_epochs_completed'] == 2
    assert bool(rec.blocks) == (scheduler is None)


@pytest.mark.parametrize('setting,expect', [('0', False), ('1', True), (None, True)])
def test_whole_fit_knob_and_checkpoints_route(small_sets, monkeypatch, tmp_path, setting,
                                              expect):
    """``COLLIE_TPU_WHOLE_FIT`` (default 1) picks the tier; a
    ``checkpoint_dir`` always takes the per-epoch loop."""
    rec = FitRecorder(trainer_module, monkeypatch)
    if setting is None:
        monkeypatch.delenv('COLLIE_TPU_WHOLE_FIT', raising=False)
    else:
        monkeypatch.setenv('COLLIE_TPU_WHOLE_FIT', setting)
    model = MatrixFactorizationModel(train=small_sets[0], embedding_dim=8, seed=0,
                                     map_location='cpu')
    CollieTrainer(model, max_epochs=2, verbosity=0).fit(model)
    assert bool(rec.blocks) == expect
    rec.blocks.clear()
    model = MatrixFactorizationModel(train=small_sets[0], embedding_dim=8, seed=0,
                                     map_location='cpu')
    CollieTrainer(model, max_epochs=2, verbosity=0, checkpoint_dir=str(tmp_path)).fit(model)
    assert not rec.blocks and (tmp_path / 'checkpoint_epoch_2.pkl').exists()


# ------------------------------------------------------------ no host reads


@contextlib.contextmanager
def no_host_reads(allowed):
    """Every Tensor method that reads a value back raises, except inside a
    function listed in ``allowed`` (a stand-in for a kernel launch)."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def raiser(name):
        def read(self, *args, **kwargs):
            if allowed[0]:
                return saved[name](self, *args, **kwargs)
            raise AssertionError(f'{name} read a device value back inside a flight')
        return read
    for name in HOST_READS:
        setattr(torch.Tensor, name, raiser(name))
    try:
        yield
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


@pytest.mark.parametrize('route', ['bucketed', 'reorder', 'padded', 'csr', 'approximate',
                                   'explicit'])
@pytest.mark.parametrize('fused', ['0', '1'])
def test_no_host_read_inside_a_flight(small_sets, monkeypatch, route, fused):
    """Each sampler route (``COLLIE_TPU_SAMPLER=padded`` takes the CSR
    sampler) and the explicit route, generic and fused (its plain
    version), with validation, early stopping and the NaN trip: no
    tensor value is read back while a flight is dispatched.  The cycle-walk
    stands in for its kernel (its plain version reads the host by design)."""
    from collie_tpu_torch import ExplicitInteractions, Interactions

    allowed = [0]
    real = scan_engine.feistel_permutation_from_keys

    def kernel_stand_in(keys, n):
        allowed[0] += 1
        try:
            return real(keys, n)
        finally:
            allowed[0] -= 1
    monkeypatch.setattr(scan_engine, 'feistel_permutation_from_keys', kernel_stand_in)
    monkeypatch.setattr(trainer_module, 'flight_guard', lambda: no_host_reads(allowed))
    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', fused)
    monkeypatch.setenv('COLLIE_TPU_SAMPLER', {'padded': 'padded', 'csr': 'csr'}.get(
        route, 'auto'))
    monkeypatch.setenv('COLLIE_TPU_SLOT_EPOCH', '0' if route == 'reorder' else '1')
    train, val = small_sets
    kwargs = {}
    if route == 'approximate':
        from collie_tpu_torch import ApproximateNegativeSamplingInteractionsDataLoader as Approx
        # the loader switches the shared Interactions to approximate sampling
        # in place: restore it for the exact routes after this one
        monkeypatch.setattr(train, 'max_number_of_samples_to_consider',
                            train.max_number_of_samples_to_consider)
        kwargs['train'] = Approx(train, batch_size=BATCH, seed=0)
    elif route == 'explicit':
        rng = np.random.default_rng(0)
        ratings = lambda m: ExplicitInteractions(  # noqa: E731
            users=m.row, items=m.col, ratings=rng.integers(1, 6, len(m.row)).astype(float),
            num_users=m.shape[0], num_items=m.shape[1], allow_missing_ids=True)
        train, val = ratings(train.mat), ratings(val.mat)
        kwargs.update(loss='mse', y_range=(1, 5))
    elif route == 'bucketed':
        # one user a degree: every bucket full, so the slot-domain epoch runs
        users = np.repeat(np.arange(64), 64)
        items = np.tile(np.arange(64), 64)
        train = Interactions(users=users, items=items, num_users=64, num_items=256,
                             num_negative_samples=5, allow_missing_ids=True, seed=0,
                             check_num_negative_samples_is_valid=False)
        val = None
    kwargs.setdefault('loss', 'adaptive')
    kwargs.setdefault('train', InteractionsDataLoader(train, batch_size=BATCH, shuffle=True,
                                                      seed=0))
    model = MatrixFactorizationModel(
        val=val if val is None else InteractionsDataLoader(val, batch_size=BATCH, seed=0),
        embedding_dim=8, lr=1e-2, seed=0, map_location='cpu', **kwargs)
    blocks = []
    build = trainer_module.build_scan_fit_fn

    def counting(*args, **kwargs):
        fn = build(*args, **kwargs)
        return lambda *a, **k: blocks.append(1) or fn(*a, **k)
    monkeypatch.setattr(trainer_module, 'build_scan_fit_fn', counting)
    trainer = CollieTrainer(model, max_epochs=3, verbosity=0, seed=0, early_stopping_patience=1,
                            terminate_on_nan=True)
    trainer.fit(model)
    assert blocks and trainer.num_epochs_completed >= 1
    epoch_fn = scan_engine.build_scan_epoch_fns(
        model, model.optimizer_specs(), [True, True], model.train_loader, shuffle=True)[0]
    assert epoch_fn.fused == (fused == '1')
    if route in ('padded', 'csr'):
        assert epoch_fn.sampler == 'csr'         # ``padded`` takes the CSR sampler
    if route == 'bucketed':
        assert epoch_fn.sampler == 'bucketed'
        assert 'packed_slots' in scan_engine.build_scan_epoch_fns(
            model, model.optimizer_specs(), [True, True], model.train_loader,
            shuffle=True)[1]


def test_cycle_walk_kernel_route_reads_nothing_back(monkeypatch):
    """On its kernel route ``feistel_permutation_from_keys`` reads no
    tensor value back: the launch is mocked on the CPU (the library's entry
    writes the plain permutation through the output pointer), every host
    read raises, and the result and the launch count are the kernel's."""
    n = 1025
    keys = torch.tensor([11, 2 ** 30 + 7, 12345, 2 ** 31 - 2], dtype=torch.int64)
    expected = shuffle.feistel_permutation_plain(keys, n)
    calls = []

    def entry(keys_ptr, n_arg, out_ptr, stream):
        calls.append((keys_ptr, n_arg, stream))
        ctypes.memmove(out_ptr, expected.data_ptr(), 4 * n_arg)
        return 0

    class FakeLibrary:
        collie_feistel_cycle_walk = staticmethod(entry)

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(shuffle, '_library', lambda: FakeLibrary)
    monkeypatch.setattr(shuffle, '_on_card', lambda t: True)
    monkeypatch.setattr(torch.cuda, 'device', lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None: FakeStream)
    before = shuffle.feistel_permutation_from_keys.launches
    with no_host_reads([0]):
        perm = shuffle.feistel_permutation_from_keys(keys, n)
    assert calls and calls[0][1] == n
    assert shuffle.feistel_permutation_from_keys.launches == before + 1
    assert perm.dtype == torch.int32 and torch.equal(perm, expected)


# ------------------------------------------------------- skipped epochs


def _implicit_args(seed, U=13, I=29, D=6, S=3, B=5, K=2):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    i = lambda hi, *shape: torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))  # noqa: E731
    return (f(U, D), f(I, D), f(I), f(U, D).abs(), f(U, D).abs(), f(I, D).abs(), f(I, D).abs(),
            torch.tensor(7, dtype=torch.int32), i(U, S, B), i(I, S, B), i(I, S, B, K),
            torch.ones(S, B))


def _explicit_args(seed, U=13, I=29, D=6, S=3, B=5):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    i = lambda hi, *shape: torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))  # noqa: E731
    return (f(U, D), f(I, D), f(U), f(I), f(U, D).abs(), f(U, D).abs(), f(I, D).abs(),
            f(I, D).abs(), torch.tensor(7, dtype=torch.int32), i(U, S, B), i(I, S, B),
            torch.from_numpy(rng.integers(1, 6, (S, B)).astype(np.float32)), torch.ones(S, B))


@pytest.mark.parametrize('explicit', [False, True])
def test_skipped_epoch_leaves_every_plain_output_bit_identical(explicit):
    """``live = False``: every table, bias, moment and the count come back
    bit for bit as they went in, the losses are NaN; ``live = True`` is the
    ordinary epoch."""
    if explicit:
        args = _explicit_args(0)
        fn, kw, n_state = fused_mf_explicit_epoch_plain, dict(loss_kind='mse', y_range=(1, 5),
                                                              wd_emb=0.01, wd_bias=0.01), 8
    else:
        args = _implicit_args(0)
        fn, kw, n_state = fused_mf_epoch_plain, dict(K=2, adaptive=True, wd_emb=0.01,
                                                     wd_bias=0.01), 7
    lrs = (torch.tensor(0.05), torch.tensor(0.01))
    skipped = fn(*args, *lrs, live=torch.tensor(False), **kw)
    for out, inp in zip(skipped[:n_state + 1], args[:n_state + 1]):
        assert torch.equal(out, inp)
    assert torch.isnan(skipped[-1]).all()
    ran = fn(*args, *lrs, live=torch.tensor(True), **kw)
    ref = fn(*args, 0.05, 0.01, **kw)
    for a, b in zip(ran, ref):
        assert torch.equal(a, b)
    assert int(ran[n_state]) == 7 + 3 and not torch.equal(ran[0], args[0])


# ------------------------------------------------- against JAX's whole fit


def test_whole_fit_matches_jax_whole_fit(data_pair, monkeypatch):  # noqa: F811
    """Both packages' default fit is the whole fit: 4 epochs (one block) on
    JAX's draws, under a plateau scheduler that cuts the learning rate every
    epoch after the first (threshold 0.5), so the learning rates exercise
    float32 rounding on both sides."""
    from collie_tpu.training import scan_engine as jax_scan_engine
    from collie_tpu.training.schedulers import ReduceLROnPlateau as JaxPlateau
    from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF

    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    (jax_train, _), (train, _) = data_pair
    common = dict(embedding_dim=8, lr=1e-1, loss='adaptive', seed=0)
    jax_model = JaxMF(train=jax_train, lr_scheduler_func=JaxPlateau(factor=0.3, patience=0,
                                                                    threshold=0.5), **common)
    model = MatrixFactorizationModel(train=train, map_location='cpu', lr_scheduler_func=
                                     ReduceLROnPlateau(factor=0.3, patience=0, threshold=0.5),
                                     **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    jax_rec = FitRecorder(jax_scan_engine, monkeypatch)
    rec = FitRecorder(trainer_module, monkeypatch)
    jax_trainer = JaxTrainer(jax_model, max_epochs=4, verbosity=0, seed=0)
    jax_trainer.fit(jax_model)
    trainer = CollieTrainer(model, max_epochs=4, verbosity=0, seed=0)
    trainer.fit(model)
    assert len(jax_rec.blocks) == len(rec.blocks) == 1
    np.testing.assert_allclose(rec.trace(0), jax_rec.trace(0), rtol=1e-4)
    np.testing.assert_array_equal(rec.trace(3), jax_rec.trace(3))
    for spec in range(2):
        np.testing.assert_array_equal(rec.lrs(spec), jax_rec.lrs(spec))
    assert len(set(rec.lrs(0))) == 4                             # cut after epochs 2-4
    for (best, num_bad), (jax_best, jax_num_bad) in zip(rec.sched, jax_rec.sched):
        np.testing.assert_allclose(best, jax_best, rtol=1e-4)
        assert int(num_bad) == int(jax_num_bad)
    assert trainer.best_epoch_loss[0] == jax_trainer.best_epoch_loss[0]
    for k, ref in jax_model.params.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(model.params[k].numpy(), ref,
                                   atol=5e-4 * max(np.abs(ref).max(), 1e-3), rtol=0,
                                   err_msg=f'param {k} diverged')
