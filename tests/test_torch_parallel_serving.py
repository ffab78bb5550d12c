"""The port's parallel serving tier on gloo against collie_tpu's on the CPU mesh.

For each mesh shape ``(data, model)`` in ``MESHES`` one
``torch.multiprocessing.spawn`` starts ``data * model`` processes
(``_worker``), joined over a ``file://`` rendezvous in ``tmp_path`` with a
gloo group of ``GROUP_TIMEOUT``; the join has ``JOIN_SECONDS`` before the
processes are killed, so a hang fails this file's tests instead of the
whole run.  Each process builds ``make_mesh(data, model, devices='cpu')``
and runs every case on the pickled port models, then writes its results;
JAX runs only in this (parent) process, on ``make_mesh(data=d, model=m,
devices=jax.devices()[:d * m])`` of the 8 CPU devices ``tests/conftest.py``
gives it.  Held:

* every rank returns the same answer;
* ``param_spec`` / ``shard_params`` follow JAX's rules, the non-divisible
  fallback included (``tests/test_parallel.py:41``);
* ``sharded_embedding_lookup``'s forward and gradient equal the dense
  gather's, with colliding ids, for a float32 and a bfloat16 table (the
  gradient is not ``n_model`` times the dense one);
* ``recommend(mesh=)`` equals JAX's ``recommend(mesh=)``: ids exactly,
  scores within 1e-5, in the local-table tier (user tables that do and do
  not divide, ``y_range``, exact ties, bfloat16 tables) and the replicated tier (a catalog
  that does not divide, a zoo model), ``filter_seen`` both ways;
* ``evaluate_in_batches(mesh=)`` equals JAX's sharded and single-device
  values within rtol 1e-5, for MF (localized view), a model whose users do
  not divide, a hybrid and ColdStart in both stages, and a zoo model
  (single-device only: ``JAX_SHARDED_EVAL_FAULT``);
* a recording wrapper around ``torch.distributed``'s collectives sees
  ``O(B x D + B x k)`` elements a call, never a table's rows
  (``tests/test_parallel_scale.py:131,237``).
"""
import datetime
import os
import pickle
import time
from unittest import mock

import numpy as np
import pytest
import torch

import collie_tpu_torch
from collie_tpu_torch import params_from_jax

MESHES = [(1, 2), (2, 2), (1, 4)]
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_SECONDS = 120
K = 7
TILE = 16
EVAL_K = 5
EVAL_BATCH = 12
USERS = np.arange(0, 40, 3)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)

_META = np.random.default_rng(7)
_HYBRID = dict(embedding_dim=8,
               item_metadata=np.eye(6, dtype=np.float32)[_META.integers(0, 6, 30)],
               user_metadata=_META.random((40, 4)).astype(np.float32),
               item_metadata_layers_dims=[8], user_metadata_layers_dims=[8],
               combined_layers_dims=[16])
_BUCKETS = dict(embedding_dim=8,
                item_buckets=np.concatenate([[0], _META.integers(0, 5, 29)]))
# name -> (class, num_users, num_items, kwargs, stage); the hybrid's and
# ColdStart's 30 items divide the model axis of 2, not of 4
MODELS = {
    'mf': ('MatrixFactorizationModel', 40, 120, dict(embedding_dim=6), None),
    'mf_odd_users': ('MatrixFactorizationModel', 41, 120, dict(embedding_dim=6), None),
    'mf_y_range': ('MatrixFactorizationModel', 40, 120, dict(embedding_dim=6, y_range=(0, 4)),
                   None),
    'mf_ties': ('MatrixFactorizationModel', 40, 120, dict(embedding_dim=6), None),
    'mf_odd_items': ('MatrixFactorizationModel', 40, 121, dict(embedding_dim=6), None),
    'mf_bf16': ('MatrixFactorizationModel', 40, 120,
                dict(embedding_dim=6, embeddings_dtype='bfloat16'), None),
    'mlp_mf': ('MLPMatrixFactorizationModel', 40, 120, dict(embedding_dim=6, num_layers=2),
               None),
    'hybrid': ('HybridModel', 40, 30, _HYBRID, 'all'),
    'cold_start_buckets': ('ColdStartModel', 40, 30, _BUCKETS, 'item_buckets'),
    'cold_start_no_buckets': ('ColdStartModel', 40, 30, _BUCKETS, 'no_buckets'),
}
RECOMMEND_CASES = [('mf', False), ('mf', True), ('mf_odd_users', False),
                   ('mf_odd_users', True), ('mf_y_range', False), ('mf_ties', False),
                   ('mf_ties', True), ('mf_odd_items', False), ('mf_odd_items', True),
                   ('mf_bf16', False), ('mlp_mf', False), ('mlp_mf', True)]
EVALUATED = ['mf', 'mf_odd_users', 'mlp_mf', 'hybrid', 'cold_start_buckets',
             'cold_start_no_buckets']
# collie_tpu's sharded evaluator fails on these: ``param_spec`` row-shards
# every leaf whose name holds 'bias', MLP-MF's ``mlp_i_bias`` vectors too,
# and its localized view reads them as shards (a shape error in ``linear``).
# The port keeps such replicated-kind leaves whole and is held to JAX's
# single-device values.
JAX_SHARDED_EVAL_FAULT = {'mlp_mf'}

# the traffic case: a catalog whose tables dwarf a request's rows
TRAFFIC = dict(num_users=64, num_items=4096, embedding_dim=8, users=8)


# ------------------------------------------------------------ the workers

def _record_collectives(log):
    """Wrap ``torch.distributed``'s collectives to log each call's elements."""
    import torch.distributed as dist

    all_reduce, all_gather = dist.all_reduce, dist.all_gather

    def reduce_(tensor, *args, **kwargs):
        log.append(('all_reduce', tensor.numel()))
        return all_reduce(tensor, *args, **kwargs)

    def gather_(parts, tensor, *args, **kwargs):
        log.append(('all_gather', tensor.numel()))
        return all_gather(parts, tensor, *args, **kwargs)

    dist.all_reduce, dist.all_gather = reduce_, gather_


def _lookup_cases(mesh):
    """Forward rows and full table gradients of the sharded lookup."""
    from collie_tpu_torch.parallel import shard_table, sharded_embedding_lookup
    from collie_tpu_torch.parallel.distributed import fetch

    out = {}
    for dtype in ('float32', 'bfloat16'):
        table, ids, cotangent = _lookup_inputs()
        shard = shard_table(torch.from_numpy(table).to(getattr(torch, dtype)), mesh)
        shard.requires_grad_(True)
        rows = sharded_embedding_lookup(shard, torch.from_numpy(ids), mesh)
        (rows * torch.from_numpy(cotangent)).sum().backward()
        out[dtype] = (rows.detach().numpy(), fetch(shard.grad, mesh, ('model', None)))
    try:
        shard_table(torch.zeros(30 if mesh.size(1) == 4 else 31, 2), mesh)
        out['indivisible'] = None
    except ValueError as err:
        out['indivisible'] = str(err)
    return out


def _lookup_inputs():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, 64, 36), [5, 5, 5, 63]]).astype(np.int64)
    cotangent = rng.standard_normal((40, 16)).astype(np.float32)
    return table, ids, cotangent


def _sharding_cases(models, mesh):
    from collie_tpu_torch.parallel import param_shardings, shard_batch_fn, shard_params
    from collie_tpu_torch.parallel.distributed import fetch, put_epoch_array

    out = {}
    for name in ('mf', 'mf_odd_users', 'mlp_mf'):
        params = models[name].params
        specs = param_shardings(params, mesh)
        local = shard_params(params, mesh)
        back = {k: fetch(v, mesh, specs[k]) for k, v in local.items()}
        out[name] = (specs, {k: tuple(v.shape) for k, v in local.items()},
                     all(np.array_equal(back[k], params[k].numpy()) for k in params))
    batch = shard_batch_fn(mesh)({'users': np.arange(8), 'items': np.arange(16).reshape(8, 2)})
    epoch = put_epoch_array(np.arange(12), mesh), put_epoch_array(np.arange(7), mesh)
    out['batch'] = ({k: v.numpy() for k, v in batch.items()}, [e.numpy() for e in epoch])
    return out


def _error_cases(mesh):
    """The messages of a mesh that does not fit the world and of a dataset
    that differs between ranks (None where nothing raised)."""
    import torch.distributed as dist

    from collie_tpu_torch.parallel import distributed, make_mesh

    out = {}
    world = dist.get_world_size()
    for name, call in (
            ('mesh_size', lambda: make_mesh(data=world + 1, model=1, devices='cpu')),
            ('mesh_model', lambda: make_mesh(model=3, devices='cpu')),
            ('same', lambda: distributed.assert_same_across_processes(
                'interactions', np.arange(10))),
            ('differs', lambda: distributed.assert_same_across_processes(
                'interactions', np.arange(10) + dist.get_rank()))):
        try:
            call()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    out['is_multiprocess'] = distributed.is_multiprocess()
    return out


def _traffic_case(mesh, log):
    """Per-call elements of the collectives for a request and an evaluation."""
    from collie_tpu_torch import (Interactions, MatrixFactorizationModel, auc,
                                  evaluate_in_batches, mapk, mrr, recommend, stratified_split)

    rng = np.random.default_rng(5)
    n = 6000
    inter = Interactions(users=rng.integers(0, TRAFFIC['num_users'], n),
                         items=rng.integers(0, TRAFFIC['num_items'], n),
                         num_users=TRAFFIC['num_users'], num_items=TRAFFIC['num_items'],
                         allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                         seed=0)
    train, test = stratified_split(inter, test_p=0.2, seed=1, force_split=True)
    model = MatrixFactorizationModel(train=train, embedding_dim=TRAFFIC['embedding_dim'],
                                     seed=0, map_location='cpu')
    out = {}
    for filter_seen in (False, True):
        del log[:]
        recommend(model, np.arange(TRAFFIC['users']), k=K, filter_seen=filter_seen,
                  item_tile=256, mesh=mesh)
        out[f'recommend_{filter_seen}'] = list(log)
    del log[:]
    evaluate_in_batches([mapk, mrr, auc], test, model, k=EVAL_K, batch_size=TRAFFIC['users'],
                        verbose=False, mesh=mesh)
    out['evaluate'] = list(log)
    out['max_degree'] = int(np.diff(test.mat.tocsr().indptr).max())
    return out


def _worker(rank, world, init_method, shape, cases_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init_method, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        from collie_tpu_torch import auc, evaluate_in_batches, mapk, mrr, recommend
        from collie_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=shape[0], model=shape[1], devices='cpu')
        with open(cases_path, 'rb') as f:
            models, tests = pickle.load(f)
        results = {'recommend': {}, 'evaluate': {}}
        for name, filter_seen in RECOMMEND_CASES:
            results['recommend'][name, filter_seen] = recommend(
                models[name], USERS, k=K, filter_seen=filter_seen, item_tile=TILE, mesh=mesh)
        for name in EVALUATED:
            results['evaluate'][name] = evaluate_in_batches(
                [mapk, mrr, auc], tests[name], models[name], k=EVAL_K, batch_size=EVAL_BATCH,
                verbose=False, mesh=mesh)
        results['lookup'] = _lookup_cases(mesh)
        results['sharding'] = _sharding_cases(models, mesh)
        results['errors'] = _error_cases(mesh)
        log = []
        _record_collectives(log)
        results['traffic'] = _traffic_case(mesh, log)
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

def _pair(name, seed=0):
    """``(jax_model, model, jax_test, test)`` of ``MODELS[name]`` on the same
    interactions and numpy params, in its stage."""
    import jax
    import jax.numpy as jnp

    import collie_tpu.data as jax_data
    import collie_tpu.models as jax_models
    from collie_tpu.models.base import BasePipeline as JaxBasePipeline
    import collie_tpu_torch.data as port_data

    cls, num_users, num_items, kwargs, stage = MODELS[name]
    rng = np.random.default_rng(seed)
    users, items = rng.integers(0, num_users, 1500), rng.integers(0, num_items, 1500)
    sets = [package.stratified_split(
        package.Interactions(users=users, items=items, num_users=num_users,
                             num_items=num_items, allow_missing_ids=True,
                             check_num_negative_samples_is_valid=False, seed=0),
        test_p=0.2, seed=1, force_split=True) for package in (jax_data, port_data)]

    def numpy_params(self, **_):
        shapes = jax.eval_shape(self._build_params, jax.random.PRNGKey(0))
        params = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
                  for k, v in sorted(shapes.items())}
        if name == 'mf_ties':   # duplicated items on a coarse grid tie exactly
            for key in params:
                params[key] = np.round(params[key] * 2)
            for key in ('item_embeddings', 'item_biases'):
                params[key][60:] = params[key][:60]
        self.params = self._apply_embeddings_dtype({k: jnp.asarray(v)
                                                    for k, v in params.items()})

    with mock.patch.object(JaxBasePipeline, '_setup_model', numpy_params):
        jax_model = getattr(jax_models, cls)(train=sets[0][0], seed=0, **kwargs)
    model = getattr(collie_tpu_torch, cls)(train=sets[1][0], seed=0, map_location='cpu',
                                           **kwargs)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    for m in (jax_model, model):
        while m.current_stage != stage:
            m.advance_stage()
    return jax_model, model, sets[0][1], sets[1][1]


@pytest.fixture(scope='module')
def pairs():
    return {name: _pair(name) for name in MODELS}


@pytest.fixture(scope='module')
def runs(pairs, tmp_path_factory):
    """``{shape: [rank results]}`` of one spawn per mesh shape."""
    directory = tmp_path_factory.mktemp('parallel_serving')
    cases_path = str(directory / 'cases.pkl')
    with open(cases_path, 'wb') as f:
        pickle.dump(({name: p[1] for name, p in pairs.items()},
                     {name: p[3] for name, p in pairs.items()}), f)
    out = {}
    for shape in MESHES:
        shape_dir = directory / f'{shape[0]}x{shape[1]}'
        shape_dir.mkdir()
        out[shape] = _spawn(shape, cases_path, str(shape_dir))
    return out


def _jax_mesh(shape):
    import jax

    from collie_tpu.parallel import make_mesh

    return make_mesh(data=shape[0], model=shape[1], devices=jax.devices()[:shape[0] * shape[1]])


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize('shape', MESHES)
def test_every_rank_returns_the_same_answer(runs, shape):
    first = runs[shape][0]
    for other in runs[shape][1:]:
        for key, (ids, scores) in first['recommend'].items():
            np.testing.assert_array_equal(other['recommend'][key][0], ids)
            np.testing.assert_array_equal(other['recommend'][key][1], scores)
        assert other['evaluate'] == first['evaluate']
        for dtype in ('float32', 'bfloat16'):
            for a, b in zip(other['lookup'][dtype], first['lookup'][dtype]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name,filter_seen', RECOMMEND_CASES)
def test_recommend_matches_jax_sharded(runs, pairs, shape, name, filter_seen):
    from collie_tpu.retrieval import recommend as jax_recommend

    jax_ids, jax_scores = jax_recommend(pairs[name][0], USERS, k=K, filter_seen=filter_seen,
                                        item_tile=TILE, mesh=_jax_mesh(shape))
    ids, scores = runs[shape][0]['recommend'][name, filter_seen]
    assert ids.dtype == np.int32 and ids.shape == (len(USERS), K)
    np.testing.assert_array_equal(ids, np.asarray(jax_ids))
    np.testing.assert_allclose(scores, np.asarray(jax_scores), **SCORE_TOL)


def _jax_evaluate(pairs, name, mesh=None):
    from collie_tpu.evaluate import evaluate_in_batches as jax_evaluate
    from collie_tpu.ops import auc, mapk, mrr

    jax_model, _, jax_test, _ = pairs[name]
    return jax_evaluate([mapk, mrr, auc], jax_test, jax_model, k=EVAL_K,
                        batch_size=EVAL_BATCH, verbose=False, mesh=mesh)


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name', EVALUATED)
def test_evaluate_matches_jax_single_device(runs, pairs, shape, name):
    np.testing.assert_allclose(runs[shape][0]['evaluate'][name], _jax_evaluate(pairs, name),
                               **METRIC_TOL)


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name', [n for n in EVALUATED if n not in JAX_SHARDED_EVAL_FAULT])
def test_evaluate_matches_jax_sharded(runs, pairs, shape, name):
    np.testing.assert_allclose(runs[shape][0]['evaluate'][name],
                               _jax_evaluate(pairs, name, _jax_mesh(shape)), **METRIC_TOL)


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name', EVALUATED)
def test_localized_view_is_chosen_as_jax_chooses_it(pairs, shape, name):
    """The port's ``_sharded_eval_param_kinds`` rule, applied to the model
    axis size alone, matches JAX's on the JAX mesh."""
    from collie_tpu.evaluate import _sharded_eval_param_kinds as jax_kinds
    from collie_tpu_torch import evaluate

    jax_model, model = pairs[name][:2]
    fake_mesh = mock.Mock(mesh_dim_names=('data', 'model'),
                          size=lambda dim: shape[dim])
    assert evaluate._sharded_eval_param_kinds(model, fake_mesh) == \
        jax_kinds(jax_model, _jax_mesh(shape))


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lookup_forward_and_gradient_equal_the_dense_gather(runs, shape, dtype):
    import jax
    import jax.numpy as jnp

    from collie_tpu.ops.embeddings import embedding_lookup as jax_embedding_lookup
    from collie_tpu_torch.ops.embeddings import embedding_lookup

    table, ids, cotangent = _lookup_inputs()
    rows, grad = runs[shape][0]['lookup'][dtype]
    jax_table = jnp.asarray(table).astype(getattr(jnp, dtype))
    dense_rows = jax_embedding_lookup(jax_table, jnp.asarray(ids.astype(np.int32)))
    dense_grad = jax.grad(lambda t: (jax_embedding_lookup(t, jnp.asarray(
        ids.astype(np.int32))) * cotangent).sum())(jax_table)
    np.testing.assert_array_equal(rows, np.asarray(dense_rows, dtype=np.float32))
    if dtype == 'float32':
        np.testing.assert_allclose(grad, np.asarray(dense_grad), rtol=1e-6)
    else:
        # the port's own dense lookup sums the same collisions the same way;
        # JAX's float32 sum may round differently to bfloat16, by one unit
        port_table = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
        (embedding_lookup(port_table, torch.from_numpy(ids))
         * torch.from_numpy(cotangent)).sum().backward()
        np.testing.assert_array_equal(grad, port_table.grad.float().numpy())
        np.testing.assert_allclose(grad, np.asarray(dense_grad, dtype=np.float32),
                                   rtol=2 ** -7, atol=0)
    # a colliding row's gradient is the sum over its ids, not n_model times it
    np.testing.assert_allclose(grad[5], cotangent[ids == 5].sum(axis=0),
                               rtol=1e-6 if dtype == 'float32' else 2 ** -7)


@pytest.mark.parametrize('shape', MESHES)
def test_shard_table_needs_divisible_rows(runs, shape):
    assert 'must divide the model axis' in runs[shape][0]['lookup']['indivisible']


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('name', ['mf', 'mf_odd_users', 'mlp_mf'])
def test_param_specs_follow_jax(runs, pairs, shape, name):
    from collie_tpu.parallel import param_shardings as jax_param_shardings

    jax_model, model = pairs[name][:2]
    specs, local_shapes, round_trip = runs[shape][0]['sharding'][name]
    jax_specs = jax_param_shardings(jax_model.params, _jax_mesh(shape))
    assert specs == {k: tuple(v.spec) for k, v in jax_specs.items()}
    for key, value in model.params.items():
        rows = value.shape[0] // shape[1] if specs[key] else value.shape[0]
        assert local_shapes[key] == (rows,) + tuple(value.shape[1:])
    assert round_trip
    if name == 'mf_odd_users':   # 41 user rows divide no model axis: replicated
        assert specs['user_embeddings'] == ()


@pytest.mark.parametrize('shape', MESHES)
def test_batches_split_over_the_data_axis(runs, shape):
    for rank, result in enumerate(runs[shape]):
        d = rank // shape[1]
        n = 8 // shape[0]
        batch, (epoch, odd) = result['sharding']['batch']
        np.testing.assert_array_equal(batch['users'], np.arange(d * n, (d + 1) * n))
        np.testing.assert_array_equal(batch['items'],
                                      np.arange(16).reshape(8, 2)[d * n:(d + 1) * n])
        m = 12 // shape[0]
        np.testing.assert_array_equal(epoch, np.arange(d * m, (d + 1) * m))
        np.testing.assert_array_equal(odd, np.arange(7))   # 7 rows: replicated


@pytest.mark.parametrize('shape', MESHES)
def test_mesh_and_dataset_errors_raise_as_jax(runs, shape):
    errors = runs[shape][0]['errors']
    world = shape[0] * shape[1]
    assert errors['mesh_size'] == f'mesh {world + 1}x1 does not match {world} available devices'
    assert errors['mesh_model'] == f'{world} devices not divisible by model=3'
    assert errors['same'] is None and errors['is_multiprocess']
    assert 'interactions differs across processes' in errors['differs']


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    from collie_tpu_torch.parallel import distributed, make_mesh

    assert not dist.is_initialized()
    distributed.initialize('localhost:1', num_processes=1, process_id=0)   # a no-op
    assert not dist.is_initialized() and not distributed.is_multiprocess()
    with pytest.raises(RuntimeError, match='initialized process group'):
        make_mesh()


@pytest.mark.parametrize('shape', MESHES)
@pytest.mark.parametrize('case', ['recommend_False', 'recommend_True', 'evaluate'])
def test_collective_traffic_is_activation_sized(runs, shape, case):
    traffic = runs[shape][0]['traffic']
    calls = traffic[case]
    B, D = TRAFFIC['users'], TRAFFIC['embedding_dim']
    if case == 'evaluate':
        B = B // shape[0]
    bound = 2 * B * max(D, K, traffic['max_degree'], 2)
    assert calls and max(n for _, n in calls) <= bound, calls
    assert max(n for _, n in calls) < TRAFFIC['num_items']
    ops = {op for op, _ in calls}
    assert ops == ({'all_reduce'} if case == 'evaluate' else {'all_reduce', 'all_gather'})
