"""The port's mesh training on gloo against collie_tpu's mesh step and the
port's own single-device fits.

For each mesh shape ``(data, model)`` in ``MESHES`` one
``torch.multiprocessing.spawn`` starts ``data * model`` processes
(``_worker``), joined over a ``file://`` rendezvous in ``tmp_path`` with a
gloo group of ``GROUP_TIMEOUT``; the join has ``JOIN_SECONDS`` before the
processes are killed, so a hang fails this file's tests instead of the
whole run.  Each process runs every case and writes its results; JAX runs
only in this (parent) process, on ``make_mesh(data=d, model=m,
devices=jax.devices()[:d * m])`` of the 8 CPU devices ``tests/conftest.py``
gives it.  Held:

* (i) the port's mesh step (``scan_engine.train_steps`` under the mesh, each
  rank on its ``data`` slice of the batch) against JAX's per-step program
  under ``make_mesh(d, m)`` (``CollieTrainer._build_steps``, params through
  ``shard_params``, moments through ``make_sharded_init``) on the same
  batches and negatives, 3 steps, for MF, MF with bfloat16 tables, MLP-MF
  on the fused and the named table layouts and ColdStart in both stages:
  losses within rtol 1e-5, params and moments within rtol 1e-4, atol 1e-5;
* (ii) a mesh fit equals the port's single-device fit for the same seed:
  the whole fit, the per-epoch loop and the per-step path, and the
  slot-domain epoch with a grouped slot count (8,193) and a batch (1,023)
  that divide no data axis (collie_tpu crashes there, ROADMAP Queue 3 item
  4); ColdStart through both stages, its item tables copied from the
  bucket tables on the shards; the model holds only its shards after the
  fit, and ``get_item_predictions`` gathers them;
* (iii) early stopping and the plateau's cuts fire on the same epoch on
  every rank, the single device's epoch;
* (iv) a recording wrapper around ``torch.distributed``'s collectives: per
  step no collective moves a whole table, and each table's ``data``-axis
  exchange stays within ``min(R_shard, R_batch) x width`` floats, in a
  regime where the batch is smaller than a shard (the all-gather of ids
  and row cotangents) and one where it is larger (the shard's all-reduce);
* (v) the moments sit on their params' shards (``make_sharded_init``);
* (vi) a dataset that differs between ranks fails at fit start.
"""
import contextlib
import datetime
import io
import os
import pickle
import time
from unittest import mock

import numpy as np
import pytest
import torch

import collie_tpu_torch
from collie_tpu_torch import params_from_jax

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_SECONDS = 150
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_EPOCHS = 2
STEPS = 3
STEP_BATCH = 12
STEP_K = 3

_META = np.random.default_rng(7)
_BUCKETS = np.concatenate([[0], _META.integers(0, 6, 59)])
# name -> (class, num_users, num_items, kwargs, stage, fused layout)
STEP_CASES = {
    'mf': ('MatrixFactorizationModel', 40, 60, {}, None, True),
    'mf_bf16': ('MatrixFactorizationModel', 40, 60, dict(embeddings_dtype='bfloat16'), None,
                False),
    'mlp_mf_fused': ('MLPMatrixFactorizationModel', 40, 60, dict(num_layers=2), None, True),
    'mlp_mf_named': ('MLPMatrixFactorizationModel', 40, 60, dict(num_layers=2), None, False),
    'cold_start_buckets': ('ColdStartModel', 40, 60, dict(item_buckets=_BUCKETS),
                           'item_buckets', True),
    'cold_start_no_buckets': ('ColdStartModel', 40, 60, dict(item_buckets=_BUCKETS),
                              'no_buckets', True),
}
# the traffic regimes: (num_users, num_items, batch); the first's batch is
# smaller than a shard of either table, the second's larger
TRAFFIC = {'small_batch': (512, 2048, 8), 'large_batch': (16, 24, 64)}
TRAFFIC_DIM = 8


# --------------------------------------------------------------- the data

def _interactions(num_users=40, num_items=60, n=1500, seed=0, negatives=3):
    from collie_tpu_torch import Interactions

    rng = np.random.default_rng(seed)
    return Interactions(users=rng.integers(0, num_users, n), items=rng.integers(0, num_items, n),
                        num_users=num_users, num_items=num_items, allow_missing_ids=True,
                        check_num_negative_samples_is_valid=False,
                        num_negative_samples=negatives, seed=0)


def _slot_interactions():
    """8,193 interactions whose grouped slot count is 8,193: user 0 holds one
    item (a bucket of one slot), users 1-32 hold 256 each (a bucket of 8,192)."""
    from collie_tpu_torch import Interactions

    rng = np.random.default_rng(0)
    users = np.concatenate([[0], np.repeat(np.arange(1, 33), 256)])
    items = np.concatenate([[5]] + [rng.choice(300, 256, replace=False) for _ in range(32)])
    return Interactions(users=users, items=items, num_users=34, num_items=300,
                        allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                        num_negative_samples=3, seed=0)


def _fit_model(case):
    """``(model, trainer kwargs, env)`` of a fit case, built the same way on
    every rank and in the parent."""
    from collie_tpu_torch import (ColdStartModel, InteractionsDataLoader,
                                  MatrixFactorizationModel, ReduceLROnPlateau, stratified_split)

    if case == 'slot':
        loader = InteractionsDataLoader(interactions=_slot_interactions(), batch_size=1023,
                                        shuffle=True, seed=0)
        return MatrixFactorizationModel(train=loader, embedding_dim=6, lr=1e-2, seed=0,
                                        map_location='cpu', loss='adaptive'), {}, {}
    train, val = stratified_split(_interactions(), test_p=0.2, seed=1, force_split=True)
    loader = InteractionsDataLoader(interactions=train, batch_size=75, shuffle=True, seed=0)
    if case == 'cold_start':
        return ColdStartModel(train=loader, item_buckets=_BUCKETS, embedding_dim=6,
                              item_buckets_stage_lr=1e-2, no_buckets_stage_lr=1e-2, seed=0,
                              map_location='cpu', loss='adaptive'), {}, {}
    if case == 'dropout':
        return MatrixFactorizationModel(train=loader, embedding_dim=6, lr=1e-2, seed=0,
                                        map_location='cpu', loss='adaptive',
                                        dropout_p=0.2), {}, {}
    if case == 'early_stop':
        val_loader = InteractionsDataLoader(interactions=val, batch_size=75, shuffle=False,
                                            seed=0)
        model = MatrixFactorizationModel(train=loader, val=val_loader, embedding_dim=6, lr=0.5,
                                         seed=0, map_location='cpu', loss='adaptive',
                                         lr_scheduler_func=ReduceLROnPlateau(patience=0))
        return model, dict(early_stopping_patience=1, max_epochs=8), {}
    model = MatrixFactorizationModel(train=loader, embedding_dim=6, lr=1e-2, seed=0,
                                     map_location='cpu', loss='adaptive')
    tiers = {'whole': ({}, {}), 'per_epoch': ({}, {'COLLIE_TPU_WHOLE_FIT': '0'}),
             'per_step': ({'epoch_mode': 'step'}, {})}
    kwargs, env = tiers[case]
    return model, kwargs, env


FIT_CASES = ['whole', 'per_epoch', 'per_step', 'slot', 'cold_start', 'early_stop', 'dropout']
# the early-stopping case trains at lr 0.5 to make the plateau cut: summation
# order moves its params by more than STATE_TOL over its epochs, so it holds
# the decisions and losses (``test_early_stopping_...``), not the params; a
# dropout fit draws each data slice's masks (``test_dropout_...``)
PARAM_FIT_CASES = [case for case in FIT_CASES if case not in ('early_stop', 'dropout')]


class _Log:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def _run_fit(case, mesh):
    """One fit case; returns what the parent compares: the whole params,
    the local shapes and layout, the logger's rows, the epoch counters and
    the learning-rate and early-stopping lines the fit printed (rank 0
    prints; the others run at verbosity 0)."""
    from collie_tpu_torch import CollieTrainer

    model, kwargs, env = _fit_model(case)
    kwargs = {'max_epochs': FIT_EPOCHS, **kwargs}
    logger = _Log()
    printed = io.StringIO()
    with mock.patch.dict(os.environ, env), contextlib.redirect_stdout(printed):
        trainer = CollieTrainer(model, verbosity=1, enable_model_summary=False, seed=0,
                                mesh=mesh, logger=logger, **kwargs)
        trainer.fit(model)
        if case == 'cold_start':
            model.advance_stage()
            trainer.max_epochs = 2 * FIT_EPOCHS
            trainer.fit(model)
    out = {'params': {k: v.float().numpy() for k, v in model.whole_params().items()},
           'local_shapes': {k: tuple(v.shape) for k, v in model.params.items()},
           'layout': None if model.param_layout() is None else model.param_layout()[1],
           'log': logger.rows, 'epochs': trainer.num_epochs_completed,
           'best': trainer.best_epoch_loss,
           'decisions': [line for line in printed.getvalue().splitlines()
                         if 'lr[' in line or 'Early stopping' in line]}
    if case == 'whole':
        out['predictions'] = model.get_item_predictions(3, sort_values=False).to_numpy()
    return out


# ------------------------------------------------------------ the workers

def _record_collectives(log, mesh, strided):
    """Wrap ``torch.distributed``'s collectives to log ``(op, axis, dtype,
    elements)`` of each call, and in ``strided`` each call given a tensor
    that is not contiguous (gloo takes one; NCCL raises)."""
    import torch.distributed as dist

    groups = {id(mesh.get_group(axis)): axis for axis in mesh.mesh_dim_names}
    all_reduce, all_gather = dist.all_reduce, dist.all_gather

    def reduce_(tensor, *args, **kwargs):
        log.append(('all_reduce', groups.get(id(kwargs.get('group'))), str(tensor.dtype),
                    tensor.numel()))
        if not tensor.is_contiguous():
            strided.append(('all_reduce', tuple(tensor.shape), tensor.stride()))
        return all_reduce(tensor, *args, **kwargs)

    def gather_(parts, tensor, *args, **kwargs):
        log.append(('all_gather', groups.get(id(kwargs.get('group'))), str(tensor.dtype),
                    tensor.numel() * len(parts)))
        if not tensor.is_contiguous():
            strided.append(('all_gather', tuple(tensor.shape), tensor.stride()))
        return all_gather(parts, tensor, *args, **kwargs)

    dist.all_reduce, dist.all_gather = reduce_, gather_
    return all_reduce, all_gather


def _mesh_steps(model, batches, mesh, fused, log=None):
    """Mesh steps of ``model`` on ``batches``; the global losses, whole
    params and whole moments after them, and the moments' local shapes.
    ``log``: the collectives' record, kept as the steps left it in
    ``'collectives'``."""
    from collie_tpu_torch.parallel.distributed import all_reduce_sum, gather_global, put_global
    from collie_tpu_torch.parallel.sharding import (init_sharded_opt_states, shard_batch_fn,
                                                    train_param_shardings)
    from collie_tpu_torch.training.scan_engine import train_steps

    specs = model.optimizer_specs()
    active = [s.stage is None or s.stage == model.current_stage for s in specs]
    pspecs = train_param_shardings(model.global_shapes(), mesh, model.hparams)
    params = {k: put_global(v, mesh, pspecs[k]) for k, v in model.params.items()}
    states = init_sharded_opt_states(specs, params, mesh)
    moment_shapes = [{k: tuple(v.shape) for k, v in getattr(st, 'mu', {}).items()}
                     for st in states]
    shard = shard_batch_fn(mesh)
    local = [shard(b) for b in batches]
    stacked = {k: torch.stack([b[k] for b in local]) for k in local[0]}
    scales = torch.tensor([float(b['mask'].sum()) / float(g['mask'].sum())
                           for b, g in zip(local, batches)])
    if log is not None:
        del log[:]
    params, states, losses = train_steps(model, specs, active, params, states, stacked, None,
                                         fused, mesh, scales)
    recorded = list(log) if log is not None else None
    losses = all_reduce_sum(torch.stack(losses), mesh, 'data').numpy()
    whole = {k: gather_global(v, mesh, pspecs[k]).float().numpy() for k, v in params.items()}
    moments = [{kind: {k: gather_global(v, mesh, pspecs[k]).numpy()
                       for k, v in getattr(st, kind, {}).items()} for kind in ('mu', 'nu')}
               for st in states]
    return {'losses': losses, 'params': whole, 'moments': moments, 'collectives': recorded,
            'moment_shapes': moment_shapes, 'param_shapes': {k: tuple(v.shape)
                                                            for k, v in params.items()}}


def _traffic(mesh, log):
    """Per-step collectives of one mesh step in each ``TRAFFIC`` regime."""
    from collie_tpu_torch import MatrixFactorizationModel

    out = {}
    for regime, (num_users, num_items, batch_size) in TRAFFIC.items():
        inter = _interactions(num_users, num_items, n=4 * num_items, seed=3, negatives=STEP_K)
        model = MatrixFactorizationModel(train=inter, embedding_dim=TRAFFIC_DIM, seed=0,
                                         map_location='cpu', loss='adaptive')
        rng = np.random.default_rng(4)
        batch = {'users': rng.integers(0, num_users, batch_size).astype(np.int32),
                 'pos_items': rng.integers(0, num_items, batch_size).astype(np.int32),
                 'neg_items': rng.integers(0, num_items, (batch_size, STEP_K)).astype(np.int32),
                 'mask': np.ones(batch_size, np.float32)}
        for fused in (True, False):
            out[regime, fused] = _mesh_steps(model, [batch], mesh, fused, log)['collectives']
    return out


def _diverged_data(mesh):
    """The error of a fit whose data differs between ranks (None: no error)."""
    import torch.distributed as dist

    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel

    inter = _interactions(seed=dist.get_rank())
    model = MatrixFactorizationModel(train=inter, embedding_dim=6, seed=0, map_location='cpu')
    try:
        CollieTrainer(model, max_epochs=1, verbosity=0, mesh=mesh).fit(model)
    except ValueError as err:
        return str(err)
    return None


def _worker(rank, world, init_method, shape, cases_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init_method, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        from collie_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=shape[0], model=shape[1], devices='cpu')
        with open(cases_path, 'rb') as f:
            models, batches = pickle.load(f)
        log, strided = [], []
        saved = _record_collectives(log, mesh, strided)
        try:
            results = {'steps': {name: _mesh_steps(models[name], batches, mesh,
                                                   STEP_CASES[name][5])
                                 for name in STEP_CASES},
                       'fits': {case: _run_fit(case, mesh) for case in FIT_CASES},
                       'diverged': _diverged_data(mesh),
                       'traffic': _traffic(mesh, log), 'strided': strided}
        finally:
            dist.all_reduce, dist.all_gather = saved
        with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(shape, cases_path, directory):
    world = shape[0] * shape[1]
    init_method = 'file://' + os.path.join(directory, 'rendezvous')
    context = torch.multiprocessing.spawn(
        _worker, args=(world, init_method, shape, cases_path, directory), nprocs=world,
        join=False)
    deadline = time.monotonic() + JOIN_SECONDS
    while not context.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for process in context.processes:
                process.kill()
            pytest.fail(f'mesh {shape}: workers did not finish in {JOIN_SECONDS} s')
    out = []
    for rank in range(world):
        with open(os.path.join(directory, f'rank{rank}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


# -------------------------------------------------------- the JAX side

def _step_batches():
    rng = np.random.default_rng(11)
    out = []
    for s in range(STEPS):
        mask = np.ones(STEP_BATCH, np.float32)
        if s == STEPS - 1:
            mask[-3:] = 0.0                  # a masked tail: the loss normalization
        out.append({'users': rng.integers(0, 40, STEP_BATCH).astype(np.int32),
                    'pos_items': rng.integers(0, 60, STEP_BATCH).astype(np.int32),
                    'neg_items': rng.integers(0, 60, (STEP_BATCH, STEP_K)).astype(np.int32),
                    'mask': mask})
    return out


def _step_pair(name):
    """``(jax_model, model)`` of ``STEP_CASES[name]`` on the same
    interactions and numpy params, in its stage."""
    import jax
    import jax.numpy as jnp

    import collie_tpu.data as jax_data
    import collie_tpu.models as jax_models
    from collie_tpu.models.base import BasePipeline as JaxBasePipeline
    import collie_tpu_torch.data as port_data

    cls, num_users, num_items, kwargs, stage, _ = STEP_CASES[name]
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, num_users, 1500), rng.integers(0, num_items, 1500)
    sets = [package.Interactions(users=users, items=items, num_users=num_users,
                                 num_items=num_items, allow_missing_ids=True,
                                 check_num_negative_samples_is_valid=False,
                                 num_negative_samples=STEP_K, seed=0)
            for package in (jax_data, port_data)]
    kwargs = dict(kwargs, embedding_dim=6, seed=0, loss='adaptive')
    if cls == 'ColdStartModel':
        kwargs.update(item_buckets_stage_lr=1e-2, no_buckets_stage_lr=1e-2)
    else:
        kwargs.update(lr=1e-2)

    def numpy_params(self, **_):
        shapes = jax.eval_shape(self._build_params, jax.random.PRNGKey(0))
        params = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
                  for k, v in sorted(shapes.items())}
        self.params = self._apply_embeddings_dtype({k: jnp.asarray(v)
                                                    for k, v in params.items()})

    with mock.patch.object(JaxBasePipeline, '_setup_model', numpy_params):
        jax_model = getattr(jax_models, cls)(train=sets[0], **kwargs)
    model = getattr(collie_tpu_torch, cls)(train=sets[1], map_location='cpu', **kwargs)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    for m in (jax_model, model):
        while m.current_stage != stage:
            m.advance_stage()
    return jax_model, model


def _jax_mesh_steps(jax_model, batches, shape):
    """JAX's per-step program under ``make_mesh(*shape)``: the losses, params
    and moments after ``STEPS`` steps."""
    import jax

    from collie_tpu.parallel import make_mesh, shard_batch_fn, shard_params
    from collie_tpu.parallel.sharding import make_sharded_init
    from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
    from collie_tpu_torch.weights import optimizer_state_from_jax

    mesh = make_mesh(data=shape[0], model=shape[1], devices=jax.devices()[:shape[0] * shape[1]])
    specs = jax_model.optimizer_specs()
    stage = jax_model.current_stage
    active = [s.stage is None or s.stage == stage for s in specs]
    step = JaxTrainer(jax_model, max_epochs=1, verbosity=0, mesh=mesh)._build_steps(
        jax_model, specs, active)[0]
    params = shard_params({k: np.asarray(v) for k, v in jax_model.params.items()}, mesh)
    states = tuple(make_sharded_init(s.transform, mesh)({k: params[k] for k in s.keys})
                   for s in specs)
    shard = shard_batch_fn(mesh)
    losses = []
    for i, batch in enumerate(batches):
        params, states, loss = step(params, states, shard(batch), jax.random.PRNGKey(0), i)
        losses.append(float(loss))
    states = [optimizer_state_from_jax(jax.device_get(s), 'cpu') for s in states]
    return {'losses': np.asarray(losses),
            'params': {k: np.asarray(v, dtype=np.float32) for k, v in params.items()},
            'moments': [{kind: {k: v.numpy() for k, v in getattr(st, kind).items()}
                         for kind in ('mu', 'nu')} for st in states]}


@pytest.fixture(scope='module')
def pairs():
    return {name: _step_pair(name) for name in STEP_CASES}


@pytest.fixture(scope='module')
def jax_steps(pairs):
    """JAX's mesh steps by ``(name, shape)``, computed once for the cases
    that differ only in the port's table layout (JAX's per-step program has
    the named layout alone)."""
    cache = {}

    def get(name, shape):
        cls, _, _, kwargs, stage, _ = STEP_CASES[name]
        key = (cls, tuple(sorted((k, str(v)) for k, v in kwargs.items())), stage, shape)
        if key not in cache:
            cache[key] = _jax_mesh_steps(pairs[name][0], _step_batches(), shape)
        return cache[key]
    return get


@pytest.fixture(scope='module')
def runs(pairs, tmp_path_factory):
    """``{shape: [rank results]}`` of one spawn per mesh shape."""
    directory = tmp_path_factory.mktemp('parallel_training')
    cases_path = str(directory / 'cases.pkl')
    with open(cases_path, 'wb') as f:
        pickle.dump(({name: p[1] for name, p in pairs.items()}, _step_batches()), f)
    out = {}
    for shape in MESHES:
        shape_dir = directory / f'{shape[0]}x{shape[1]}'
        shape_dir.mkdir()
        out[shape] = _spawn(shape, cases_path, str(shape_dir))
    return out


@pytest.fixture(scope='module')
def single_fits():
    torch.set_num_threads(1)
    return {case: _run_fit(case, None) for case in FIT_CASES}


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name', list(STEP_CASES))
def test_mesh_step_matches_jax_mesh_step(runs, jax_steps, shape, name):
    ref = jax_steps(name, shape)
    for rank, result in enumerate(runs[shape]):
        got = result['steps'][name]
        np.testing.assert_allclose(got['losses'], ref['losses'], **LOSS_TOL,
                                   err_msg=f'rank {rank}')
        for key, value in ref['params'].items():
            np.testing.assert_allclose(got['params'][key], value, **STATE_TOL,
                                       err_msg=f'rank {rank} {key}')
        for got_state, ref_state in zip(got['moments'], ref['moments']):
            for kind in ('mu', 'nu'):
                for key, value in ref_state[kind].items():
                    np.testing.assert_allclose(got_state[kind][key], value, **STATE_TOL,
                                               err_msg=f'rank {rank} {kind} {key}')


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('case', PARAM_FIT_CASES)
def test_mesh_fit_equals_single_device_fit(runs, single_fits, shape, case):
    ref = single_fits[case]
    for rank, result in enumerate(runs[shape]):
        got = result['fits'][case]
        assert got['epochs'] == ref['epochs'] and got['best'][0] == ref['best'][0]
        assert [step for step, _ in got['log']] == [step for step, _ in ref['log']]
        for (_, metrics), (_, ref_metrics) in zip(got['log'], ref['log']):
            assert metrics.keys() == ref_metrics.keys()
            for key, value in ref_metrics.items():
                np.testing.assert_allclose(metrics[key], value, **LOSS_TOL,
                                           err_msg=f'rank {rank} {key}')
        for key, value in ref['params'].items():
            np.testing.assert_allclose(got['params'][key], value, **STATE_TOL,
                                       err_msg=f'rank {rank} {key}')
        if case == 'whole':
            np.testing.assert_allclose(got['predictions'], ref['predictions'], **STATE_TOL)


@pytest.mark.parametrize('shape', MESHES)
def test_dropout_masks_follow_the_data_slice(runs, single_fits, shape):
    """Each ``data`` rank draws the masks of its own rows (its index mixed
    into the step seeds), the ``model`` ranks of a slice the same ones: a
    mesh with one ``data`` rank draws the single device's masks and equals
    its fit; every rank of any mesh ends with the same params."""
    first = runs[shape][0]['fits']['dropout']['params']
    for result in runs[shape][1:]:
        for key, value in first.items():
            np.testing.assert_array_equal(result['fits']['dropout']['params'][key], value)
    ref = single_fits['dropout']['params']
    if shape[0] == 1:
        for key, value in ref.items():
            np.testing.assert_allclose(first[key], value, **STATE_TOL, err_msg=key)
    else:
        assert any(not np.allclose(first[k], v, **STATE_TOL) for k, v in ref.items())


@pytest.mark.parametrize('shape', MESHES)
def test_model_holds_only_its_shards(runs, shape):
    from collie_tpu_torch.parallel.sharding import train_param_spec

    n_model = shape[1]
    for result in runs[shape]:
        got = result['fits']['whole']
        for key, full in got['params'].items():
            spec = got['layout'][key]
            rows = full.shape[0] // n_model if spec else full.shape[0]
            assert got['local_shapes'][key] == (rows,) + full.shape[1:], key
            mesh = mock.Mock(mesh_dim_names=('data', 'model'), size=lambda dim: shape[dim])
            assert spec == train_param_spec(key, full.shape, mesh,
                                            {'num_users': 40, 'num_items': 60})
        if n_model > 1:
            assert got['layout']['item_embeddings'] == ('model', None)
            assert got['layout']['user_biases'] == ('model',)


def test_slot_case_takes_the_slot_epoch_with_odd_counts():
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    model, _, _ = _fit_model('slot')
    specs = model.optimizer_specs()
    _, data, _, _ = build_scan_epoch_fns(model, specs, [True] * len(specs), model.train_loader,
                                         shuffle=True)
    assert len(data['packed_slots']) == 8193 and model.train_loader.batch_size == 1023


@pytest.mark.parametrize('shape', MESHES)
def test_early_stopping_and_plateau_fire_on_the_same_epoch(runs, single_fits, shape):
    ref = single_fits['early_stop']
    assert ref['epochs'] < 8, 'the case must stop early'
    assert any('lr[' in line for line in ref['decisions']), 'the plateau must cut'
    assert runs[shape][0]['fits']['early_stop']['decisions'] == ref['decisions']
    lr_rows = [metrics for _, metrics in ref['log']]
    assert len(lr_rows) == ref['epochs']
    for result in runs[shape]:
        got = result['fits']['early_stop']
        assert (got['epochs'], got['best'][0]) == (ref['epochs'], ref['best'][0])
        for (_, metrics), row in zip(got['log'], lr_rows):
            np.testing.assert_allclose(metrics['val_loss_epoch'], row['val_loss_epoch'],
                                       **LOSS_TOL)


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('regime', list(TRAFFIC))
@pytest.mark.parametrize('fused', [True, False])
def test_step_collectives_stay_within_their_bounds(runs, shape, regime, fused):
    num_users, num_items, batch = TRAFFIC[regime]
    n_data, n_model = shape
    rows = {'users': num_users, 'items': num_items}
    widths = [TRAFFIC_DIM + 1] if fused else [TRAFFIC_DIM, 1]
    # R_batch: B user rows, (K + 1) B item rows a global step looks up
    bound = max(min(rows[kind] // (n_model if rows[kind] % n_model == 0 else 1),
                    (batch if kind == 'users' else (STEP_K + 1) * batch)) * width
                for kind in rows for width in widths)
    calls = runs[shape][0]['traffic'][regime, fused]
    data_calls = [c for c in calls if c[1] == 'data']
    assert all(n <= bound for op, _, dtype, n in data_calls if dtype == 'torch.float32'), \
        (bound, data_calls)
    smallest_table = min(rows.values()) * min(widths)
    if regime == 'small_batch':
        assert all(n < smallest_table for *_, n in calls), calls
        if n_data > 1:
            assert {op for op, axis, _, _ in data_calls} >= {'all_gather'}
    elif n_data > 1:
        shard_rows = [r // n_model if r % n_model == 0 else r for r in rows.values()]
        exchanged = sorted(n for op, axis, _, n in data_calls if op == 'all_reduce')
        assert all(r * w in exchanged for r in shard_rows for w in widths), exchanged
    if n_model > 1:
        assert any(axis == 'model' for _, axis, _, _ in calls)


@pytest.mark.parametrize('shape', MESHES)
def test_collectives_take_contiguous_tensors(runs, shape):
    """Every collective of every case got a contiguous tensor, as NCCL
    requires on the card."""
    for result in runs[shape]:
        assert result['strided'] == []


@pytest.mark.parametrize('shape', MESHES)
def test_moments_sit_on_their_params_shards(runs, shape):
    for result in runs[shape]:
        for name, got in result['steps'].items():
            for moments in got['moment_shapes']:
                for key, moment_shape in moments.items():
                    assert moment_shape == got['param_shapes'][key], (name, key)
        mf = result['steps']['mf']['moment_shapes']
        if shape[1] > 1:
            assert any(m.get('item_embeddings') == (60 // shape[1], 6) for m in mf)


@pytest.mark.parametrize('shape', MESHES)
def test_divergent_data_fails_at_fit_start(runs, shape):
    for result in runs[shape]:
        assert 'train data differs across processes' in result['diverged']
