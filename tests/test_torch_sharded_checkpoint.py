"""The port's per-shard ``.shards`` checkpoints against collie_tpu's.

collie_tpu writes a ``.shards`` directory from a mesh fit
(``collie_tpu/parallel/checkpoint.py``): per process an npz of the shards
it owns, entries named ``{leaf}__{start_stop_step...}``, and a
``meta.pkl``.  Held here:

* the port writes that layout: the same entry names, leaf metadata and
  ``meta.pkl`` keys as collie_tpu for the same tree, one writer a distinct
  shard, round-robin over its holders (gloo processes here, JAX's devices
  of one process there);
* the port reads a ``.shards`` directory collie_tpu wrote from a fit on
  an 8-device mesh, on a ``(2, 2)`` and a ``(1, 4)`` gloo mesh and on one
  device (there also with ``jax``, ``optax``, ``ml_dtypes`` and
  ``collie_tpu`` blocked), and restores the same params and optimizer
  state;
* a port mesh fit resumed from its own ``.shards`` equals the uninterrupted
  fit, on the mesh and on one device (collie_tpu's
  ``tests/test_multiprocess.py:104-196``);
* after a mesh fit the model holds only its shards, ``save_model`` writes
  the npz of the single-device model, and collie_tpu loads it.

Workers as in ``test_torch_parallel_serving.py``: one spawn a mesh shape,
a ``file://`` rendezvous, ``GROUP_TIMEOUT`` and ``JOIN_SECONDS``.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

MESHES = [(2, 2), (1, 4)]
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_SECONDS = 120
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
RESUME_FROM = 2
EPOCHS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(package):
    """The same interactions in either package."""
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 40, 1500), rng.integers(0, 60, 1500)
    inter = package.Interactions(users=users, items=items, num_users=40, num_items=60,
                                 allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                                 num_negative_samples=3, seed=0)
    train, _ = package.stratified_split(inter, test_p=0.2, seed=1, force_split=True)
    return package.InteractionsDataLoader(interactions=train, batch_size=75, shuffle=True, seed=0)


def _port_model():
    import collie_tpu_torch

    return collie_tpu_torch.MatrixFactorizationModel(
        train=_data(collie_tpu_torch), embedding_dim=6, lr=1e-2, seed=0, map_location='cpu',
        loss='adaptive')


def _restored_state(path, mesh):
    """The params and optimizer states a fit resumed from ``path`` on
    ``mesh`` starts from, gathered whole."""
    from collie_tpu_torch import CollieTrainer
    from collie_tpu_torch.parallel.distributed import gather_global
    from collie_tpu_torch.parallel.sharding import init_sharded_opt_states

    model = _port_model()
    trainer = CollieTrainer(model, max_epochs=EPOCHS, verbosity=0, mesh=mesh)
    assert trainer.resume_from_checkpoint(path) == RESUME_FROM
    params = trainer._fit_params(model)
    fresh = init_sharded_opt_states(model.optimizer_specs(), params, mesh)
    ckpt = trainer._read_sharded(trainer._pending_resume['sharded_path'], params)
    params, states, _ = trainer._restore(model, ckpt, fresh,
                                         [None] * len(model.optimizer_specs()))
    specs = trainer._specs or {}

    def whole(key, value):
        return gather_global(value, mesh, specs.get(key, ())).numpy() if mesh else value.numpy()

    return {'params': {k: whole(k, v) for k, v in params.items()},
            'states': [{'lr': float(st.learning_rate), 'count': int(st.count),
                        **{f'{kind}:{k}': whole(k, v)
                           for kind in ('mu', 'nu') for k, v in getattr(st, kind).items()}}
                       for st in states],
            'local': {k: tuple(v.shape) for k, v in params.items()}}


def _fit(mesh, epochs, directory=None, resume=None):
    """A port fit to ``epochs``: whole params after it, the model's local
    shapes and layout."""
    from collie_tpu_torch import CollieTrainer

    model = _port_model()
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, mesh=mesh, seed=0,
                            checkpoint_dir=directory)
    if resume is not None:
        trainer.resume_from_checkpoint(resume)
    trainer.fit(model)
    return model


def _worker(rank, world, init_method, shape, jax_ckpt, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init_method, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        from collie_tpu_torch.parallel import make_mesh
        from collie_tpu_torch.parallel.checkpoint import save_sharded_pytree
        from collie_tpu_torch.parallel.distributed import put_global

        mesh = make_mesh(data=shape[0], model=shape[1], devices='cpu')
        results = {'jax': _restored_state(jax_ckpt, mesh)}
        ckpt_dir = os.path.join(out_dir, 'port')
        _fit(mesh, RESUME_FROM, directory=ckpt_dir)
        own = os.path.join(ckpt_dir, f'checkpoint_epoch_{RESUME_FROM}.shards')
        resumed = _fit(mesh, EPOCHS, resume=own)
        whole = _fit(mesh, EPOCHS)
        results['resumed'] = {k: v.numpy() for k, v in resumed.whole_params().items()}
        results['uninterrupted'] = {k: v.numpy() for k, v in whole.whole_params().items()}
        results['local'] = {k: tuple(v.shape) for k, v in whole.params.items()}
        results['layout'] = whole.param_layout()[1]
        whole.save_model(os.path.join(out_dir, 'model.npz'))
        layout_tree = _layout_tree()
        spec = {'table': ('model', None), 'bias': ('model',)}
        save_sharded_pytree(
            os.path.join(out_dir, 'layout.shards'),
            {k: (put_global(v, mesh, spec[k]) if k in spec else v) for k, v in layout_tree.items()},
            {'epoch': 1}, mesh=mesh, specs=lambda path, _: spec.get(path[-1], ()))
        with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _layout_tree():
    rng = np.random.default_rng(5)
    return {'table': torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)),
            'bias': torch.from_numpy(rng.standard_normal(8).astype(np.float32)),
            'dense': torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)),
            'count': torch.tensor(7, dtype=torch.int32)}


def _spawn(shape, jax_ckpt, directory):
    world = shape[0] * shape[1]
    init_method = 'file://' + os.path.join(directory, 'rendezvous')
    context = torch.multiprocessing.spawn(
        _worker, args=(world, init_method, shape, jax_ckpt, directory), nprocs=world,
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

@pytest.fixture(scope='module')
def jax_checkpoint(tmp_path_factory):
    """A ``.shards`` directory of collie_tpu's MF fit on ``make_mesh(4, 2)``
    of the 8 CPU devices, and the state it holds, read back by collie_tpu
    onto one device."""
    import jax
    from jax.sharding import SingleDeviceSharding

    import collie_tpu.data as jax_data
    from collie_tpu.models import MatrixFactorizationModel as JaxMF
    from collie_tpu.parallel import make_mesh
    from collie_tpu.parallel.checkpoint import load_sharded_pytree
    from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
    from collie_tpu_torch.weights import optimizer_state_from_jax

    directory = tmp_path_factory.mktemp('jax_shards')
    model = JaxMF(train=_data(jax_data), embedding_dim=6, lr=1e-2, seed=0, loss='adaptive')
    JaxTrainer(model, max_epochs=RESUME_FROM, verbosity=0, seed=0,
               mesh=make_mesh(data=4, model=2), checkpoint_dir=str(directory)).fit(model)
    path = directory / f'checkpoint_epoch_{RESUME_FROM}.shards'
    with open(path / 'meta.pkl', 'rb') as f:
        skeleton = pickle.load(f)['skeleton']
    one = SingleDeviceSharding(jax.devices()[0])
    tree, _ = load_sharded_pytree(path, jax.tree_util.tree_map(lambda _: one, skeleton))
    states = [optimizer_state_from_jax(jax.device_get(s), 'cpu') for s in tree['opt_states']]
    state = {'params': {k: np.asarray(v) for k, v in tree['params'].items()},
             'states': [{'lr': float(st.learning_rate), 'count': int(st.count),
                         **{f'{kind}:{k}': v.numpy()
                            for kind in ('mu', 'nu') for k, v in getattr(st, kind).items()}}
                        for st in states]}
    return str(path), state


@pytest.fixture(scope='module')
def runs(jax_checkpoint, tmp_path_factory):
    directory = tmp_path_factory.mktemp('sharded_checkpoint')
    out = {}
    for shape in MESHES:
        shape_dir = directory / f'{shape[0]}x{shape[1]}'
        shape_dir.mkdir()
        out[shape] = (_spawn(shape, jax_checkpoint[0], str(shape_dir)), shape_dir)
    return out


@pytest.fixture(scope='module')
def single(tmp_path_factory):
    """The port's single-device fits: uninterrupted, and the mesh-free
    resume of the (2, 2) mesh's checkpoint is made in its test."""
    torch.set_num_threads(1)
    return {k: v.numpy() for k, v in _fit(None, EPOCHS).params.items()}


def _assert_state(got, ref):
    for key, value in ref['params'].items():
        np.testing.assert_allclose(got['params'][key], value, **STATE_TOL, err_msg=key)
    assert len(got['states']) == len(ref['states'])
    for got_state, ref_state in zip(got['states'], ref['states']):
        assert got_state.keys() == ref_state.keys()
        for key, value in ref_state.items():
            np.testing.assert_allclose(got_state[key], value, **STATE_TOL, err_msg=key)


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize('shape', MESHES)
def test_reads_collie_tpu_shards_on_a_mesh(runs, jax_checkpoint, shape):
    for result in runs[shape][0]:
        _assert_state(result['jax'], jax_checkpoint[1])
        assert result['jax']['local']['item_embeddings'] == (60 // shape[1], 6)


def test_reads_collie_tpu_shards_on_one_device(jax_checkpoint):
    _assert_state(_restored_state(jax_checkpoint[0], None), jax_checkpoint[1])


def test_reads_collie_tpu_shards_without_jax(jax_checkpoint, tmp_path):
    """The same read in a fresh interpreter where ``jax``, ``optax``,
    ``ml_dtypes`` and ``collie_tpu`` cannot be imported."""
    out = tmp_path / 'state.pkl'
    script = (
        'import sys, pickle\n'
        'for name in ("jax", "optax", "ml_dtypes", "collie_tpu"):\n'
        '    sys.modules[name] = None\n'
        f'sys.path.insert(0, {REPO!r})\n'
        'from tests.test_torch_sharded_checkpoint import _restored_state\n'
        f'state = _restored_state({jax_checkpoint[0]!r}, None)\n'
        f'pickle.dump(state, open({str(out)!r}, "wb"))\n')
    subprocess.run([sys.executable, '-c', script], check=True, cwd=REPO, timeout=120,
                   env={**os.environ, 'PYTHONPATH': REPO})
    with open(out, 'rb') as f:
        _assert_state(pickle.load(f), jax_checkpoint[1])


@pytest.mark.parametrize('shape', MESHES)
def test_mesh_resume_equals_the_uninterrupted_fit(runs, single, shape):
    for result in runs[shape][0]:
        for key, value in single.items():
            np.testing.assert_allclose(result['resumed'][key], value, **STATE_TOL, err_msg=key)
            np.testing.assert_allclose(result['uninterrupted'][key], value, **STATE_TOL,
                                       err_msg=key)


def test_mesh_checkpoint_resumes_on_one_device(runs, single):
    _, shape_dir = runs[(2, 2)]
    resumed = _fit(None, EPOCHS, resume=str(shape_dir / 'port' /
                                            f'checkpoint_epoch_{RESUME_FROM}.shards'))
    for key, value in single.items():
        np.testing.assert_allclose(resumed.params[key].numpy(), value, **STATE_TOL, err_msg=key)


@pytest.mark.parametrize('shape', MESHES)
def test_model_holds_its_shards_and_saves_the_whole_npz(runs, single, shape):
    from collie_tpu.models import MatrixFactorizationModel as JaxMF
    from collie_tpu_torch import MatrixFactorizationModel

    results, shape_dir = runs[shape]
    for result in results:
        assert result['local']['item_embeddings'] == (60 // shape[1], 6)
        assert result['local']['user_biases'] == (40 // shape[1],)
        assert result['layout']['item_embeddings'] == ('model', None)
    path = str(shape_dir / 'model.npz')
    loaded = MatrixFactorizationModel(load_model_path=path, map_location='cpu')
    jax_loaded = JaxMF(load_model_path=path)
    for key, value in results[0]['uninterrupted'].items():
        np.testing.assert_array_equal(loaded.params[key].numpy(), value)
        np.testing.assert_array_equal(np.asarray(jax_loaded.params[key]), value)
        np.testing.assert_allclose(value, single[key], **STATE_TOL)


def _jax_layout(directory, shape):
    """collie_tpu's ``.shards`` of ``_layout_tree`` on a mesh of ``shape``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from collie_tpu.parallel import make_mesh
    from collie_tpu.parallel.checkpoint import save_sharded_pytree

    mesh = make_mesh(data=shape[0], model=shape[1], devices=jax.devices()[:shape[0] * shape[1]])
    spec = {'table': P('model', None), 'bias': P('model')}
    tree = {k: jax.device_put(jnp.asarray(v.numpy()), NamedSharding(mesh, spec.get(k, P())))
            for k, v in _layout_tree().items()}
    save_sharded_pytree(directory, tree, {'epoch': 1})
    return directory


@pytest.mark.parametrize('shape', MESHES)
def test_writes_the_layout_collie_tpu_writes(runs, tmp_path, shape):
    from collie_tpu_torch.parallel.checkpoint import read_meta

    port_dir = runs[shape][1] / 'layout.shards'
    jax_dir = _jax_layout(tmp_path / 'jax.shards', shape)
    port_meta, jax_meta = read_meta(port_dir), read_meta(jax_dir)
    assert port_meta.keys() == jax_meta.keys() == {'skeleton', 'leaf_meta', 'host_payload',
                                                   'process_count'}
    assert port_meta['process_count'] == shape[0] * shape[1]
    port_entries, writers = {}, set()
    for rank in range(shape[0] * shape[1]):
        with np.load(port_dir / f'shards_p{rank}.npz') as z:
            for name in z.files:
                assert name not in port_entries, f'{name} written twice'
                port_entries[name] = z[name]
                writers.add(rank)
    with np.load(jax_dir / 'shards_p0.npz') as z:
        jax_entries = {name: z[name] for name in z.files}
    assert port_entries.keys() == jax_entries.keys()
    for name, value in jax_entries.items():
        np.testing.assert_array_equal(port_entries[name], value)
    for (kind, info), (jax_kind, jax_info) in zip(port_meta['leaf_meta'],
                                                  jax_meta['leaf_meta']):
        assert kind == jax_kind == 'array'
        assert tuple(info[0]) == tuple(jax_info[0]) and info[1] == jax_info[1]
        assert [key for key, _ in info[2]] == [tuple(key) for key, _ in jax_info[2]]
        # one writer a distinct shard, round-robin over the ranks holding it
        # (rank r at data r // model, model r % model)
        for ordinal, (key, owner) in enumerate(info[2]):
            rows = key[0] if key else (None, None, None)
            holders = [r for r in range(shape[0] * shape[1])
                       if rows[0] is None or rows[0] == (r % shape[1]) * (rows[1] - rows[0])]
            assert owner == holders[ordinal % len(holders)]
    assert len(writers) > 1
