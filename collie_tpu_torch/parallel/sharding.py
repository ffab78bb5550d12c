"""Sharding rules for params, optimizer state and batches.

Port of ``collie_tpu/parallel/sharding.py``.  Rules:

* embedding / bias tables (leading dim = num_users or num_items) are
  row-sharded over the ``model`` axis when divisible, else replicated;
* every other parameter (MLP towers are tiny) is replicated;
* optimizer moments sit beside their param's shard (``make_sharded_init``);
* batch leaves are split over the ``data`` axis on their leading dim.

A spec is the tuple form of JAX's ``PartitionSpec`` (``distributed``'s
docstring): ``('model', None)`` for a row-sharded table, ``()`` replicated.

``param_spec`` is JAX's rule, and serving follows it.  Training follows
``train_param_spec``, which row-shards only the tables the models read by
id (see its docstring).
"""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from collie_tpu_torch.parallel.distributed import put_global
from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size


def param_spec(name: str, value, mesh: DeviceMesh) -> Tuple:
    """The spec of a single flat param."""
    model_size = axis_size(mesh, MODEL_AXIS)
    shape = tuple(value.shape)
    shard_rows = (
        model_size > 1
        and len(shape) >= 1
        and shape[0] % model_size == 0
        and ('embedding' in name or 'bias' in name)
    )
    if shard_rows:
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def param_shardings(params: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, Tuple]:
    return {name: param_spec(name, value, mesh) for name, value in params.items()}


def shard_params(params: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of every param (row shards of the tables, whole
    replicated leaves), on the mesh's device."""
    shardings = param_shardings(params, mesh)
    return {name: put_global(value, mesh, shardings[name]) for name, value in params.items()}


def table_rows(name: str, hparams) -> Optional[int]:
    """The row count of the id space a leaf named ``name`` is read by, when
    it is one of the tables the models gather by id: ``user_*`` / ``item_*``
    / ``item_bucket_*`` leaves named ``..._embeddings[...]``,
    ``..._biases`` or ``..._fused`` (the generic epoch's fused layout).
    None for every other leaf (layers, global biases, metadata towers)."""
    for prefix, key in (('item_bucket_', 'num_item_buckets'), ('user_', 'num_users'),
                        ('item_', 'num_items')):
        if name.startswith(prefix):
            rest = name[len(prefix):]
            if rest.startswith('embeddings') or rest in ('biases', 'fused'):
                rows = hparams.get(key)
                return None if rows is None else int(rows)
            return None
    return None


def is_id_table(name: str, shape: Sequence[int], hparams) -> bool:
    """Whether the leaf ``name`` of global ``shape`` is a table read by id."""
    rows = table_rows(name, hparams)
    return rows is not None and len(shape) >= 1 and shape[0] == rows


def train_param_spec(name: str, shape: Sequence[int], mesh: DeviceMesh, hparams) -> Tuple:
    """The spec of a param in mesh training: row-sharded over ``model`` for
    a table read by id (``is_id_table``) whose rows divide the axis, else
    replicated.

    It differs from ``param_spec`` (JAX's rule, kept for serving) in what it
    leaves whole: ``param_spec`` row-shards any divisible leaf whose name
    holds ``bias``, an MLP layer's bias vector included.  Under JAX's GSPMD
    that changes only the layout, but here a shard is what a rank holds and
    computes with, and a layer reads its whole bias.  So only the tables
    that every lookup reaches through ``parallel.embedding`` are split."""
    model_size = axis_size(mesh, MODEL_AXIS)
    shape = tuple(shape)
    if model_size > 1 and is_id_table(name, shape, hparams) and shape[0] % model_size == 0:
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def train_param_shardings(shapes: Dict[str, Sequence[int]], mesh: DeviceMesh,
                          hparams) -> Dict[str, Tuple]:
    """``train_param_spec`` of every leaf, from the global shapes."""
    return {name: train_param_spec(name, shape, mesh, hparams) for name, shape in shapes.items()}


def global_shape(local_shape: Sequence[int], mesh: Optional[DeviceMesh],
                 spec: Sequence) -> Tuple[int, ...]:
    """The shape of the array whose shard under ``spec`` has ``local_shape``."""
    return tuple(n * (axis_size(mesh, axis) if axis is not None else 1)
                 for n, axis in zip(local_shape, tuple(spec) + (None,) * len(local_shape)))


def shard_batch_fn(mesh: DeviceMesh) -> Callable:
    """Returns ``batch -> batch`` giving each rank its rows of every leaf
    (split over ``data``, the same on every ``model`` rank).

    A batch whose rows do not divide the ``data`` axis is padded to the next
    multiple with rows of id 0 and mask 0, a ``mask`` of ones for the real
    rows added where the batch has none; JAX's ``shard_batch_fn`` takes only
    divisible batches."""
    n_data = axis_size(mesh, DATA_AXIS)

    def _shard(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = {key: np.asarray(value) for key, value in batch.items()}
        rows = len(next(iter(batch.values())))
        pad = -rows % n_data
        if pad:
            batch.setdefault('mask', np.ones(rows, np.float32))
            batch = {key: np.concatenate([value, np.zeros((pad,) + value.shape[1:],
                                                          value.dtype)])
                     for key, value in batch.items()}
        return {key: put_global(value, mesh, (DATA_AXIS,)) for key, value in batch.items()}
    return _shard


def _moment_key(path: Tuple) -> Optional[str]:
    """The innermost dict key on an optimizer-state leaf's path."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return None


def make_sharded_init(transform, mesh: DeviceMesh) -> Callable:
    """Optimizer-state init whose moments sit beside their params' shards.

    Port of ``collie_tpu/parallel/sharding.py:67-105``.  ``init(sub_params)``
    takes this rank's shards (``shard_params``) and returns the state with
    every moment leaf (matched to its param by dict key and shape) shaped
    like, and on the device of, that shard, and everything else (counts, the
    learning rate) replicated: each rank holds the same value.  JAX needs
    ``out_shardings`` to keep ``zeros_like`` from landing on one device;
    here a rank's init sees only its shards, so the rule is checked, not
    imposed: a moment of a param's shape that is not the shard's raises."""
    from collie_tpu_torch.training.optimizers import state_paths

    def init(sub_params: Dict[str, torch.Tensor]):
        state = transform.init(sub_params)
        for path, leaf in state_paths(state):
            key = _moment_key(path)
            if torch.is_tensor(leaf) and key in sub_params and leaf.dim():
                if tuple(leaf.shape) != tuple(sub_params[key].shape) \
                        or leaf.device != sub_params[key].device:
                    raise ValueError(f'moment {path} of {key!r} is {tuple(leaf.shape)} on '
                                     f'{leaf.device}, not beside its shard '
                                     f'{tuple(sub_params[key].shape)}')
        return state

    return init


def init_sharded_opt_states(specs, params: Dict[str, torch.Tensor],
                            mesh: DeviceMesh = None) -> Tuple[Any, ...]:
    """Each optimizer spec's state, its moments beside the (possibly
    sharded) params they belong to (``make_sharded_init``)."""
    if mesh is not None:
        return tuple(make_sharded_init(spec.transform, mesh)({k: params[k] for k in spec.keys})
                     for spec in specs)
    return tuple(spec.transform.init({k: params[k] for k in spec.keys}) for spec in specs)


def data_slice(rows: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """``(start, rows a rank)`` of this rank's ``data`` slice of ``rows``
    padded to a multiple of the axis (``shard_batch_fn``)."""
    n_data = axis_size(mesh, DATA_AXIS)
    local = -(-rows // n_data)
    return axis_index(mesh, DATA_AXIS) * local, local
