"""Device-mesh construction.

Port of ``collie_tpu/parallel/mesh.py``.  The reference's only distribution
story is handing ``gpus=k`` to PyTorch-Lightning (DDP/NCCL under the hood,
``collie/model/base/trainer.py:71-79``).  ``collie_tpu`` builds one
``jax.sharding.Mesh`` with two axes, and so does the port, as a
``torch.distributed`` ``DeviceMesh`` over the initialized process group,
one process a device:

* ``data``: batch rows (evaluation users) are split here;
* ``model``: embedding-table rows are split here (tensor parallelism for
  the only large parameters of the workload), and so is the catalog when
  serving and evaluating.

JAX runs one controller over the whole mesh; here every rank runs the same
program on its own slice (SPMD), calls the same entry point with the same
arguments and gets the same full answer.  The collectives run on NCCL for
``cuda`` meshes and on gloo for ``cpu`` ones.
"""
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


def make_mesh(data: Optional[int] = None,
              model: int = 1,
              devices: Optional[str] = None) -> DeviceMesh:
    """Build a ``(data, model)`` mesh over the processes of the initialized
    process group (``distributed.initialize`` or
    ``torch.distributed.init_process_group``), rank ``r`` at row
    ``r // model``, column ``r % model``.

    ``data=None`` puts all remaining processes on the data axis.
    ``devices``: the device type of the mesh, ``'cuda'`` (the default, rank
    ``r`` on ``cuda:(r % device_count)``) or ``'cpu'``.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs an initialized process group: call '
            '``collie_tpu_torch.parallel.distributed.initialize(...)`` or '
            '``torch.distributed.init_process_group(...)`` first')
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f'{n} devices not divisible by model={model}')
        data = n // model
    if data * model != n:
        raise ValueError(f'mesh {data}x{model} does not match {n} available devices')
    device_type = devices or 'cuda'
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass ``devices='cpu'``")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of processes along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device of the mesh."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)
