"""Sharding rules for params and batches.

Port of ``collie_tpu/parallel/sharding.py:26-64``.  Rules:

* embedding / bias tables (leading dim = num_users or num_items) are
  row-sharded over the ``model`` axis when divisible, else replicated;
* every other parameter (MLP towers are tiny) is replicated;
* batch leaves are split over the ``data`` axis on their leading dim.

A spec is the tuple form of JAX's ``PartitionSpec`` (``distributed``'s
docstring): ``('model', None)`` for a row-sharded table, ``()`` replicated.
The optimizer-state half (``make_sharded_init``,
``init_sharded_opt_states``) belongs to sharded training, not ported yet.
"""
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from collie_tpu_torch.parallel.distributed import put_global
from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size


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


def shard_batch_fn(mesh: DeviceMesh) -> Callable:
    """Returns ``batch -> batch`` giving each rank its rows of every leaf
    (split over ``data``, the same on every ``model`` rank)."""
    def _shard(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {key: put_global(value, mesh, (DATA_AXIS,)) for key, value in batch.items()}
    return _shard
