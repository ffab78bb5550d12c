"""Multi-process execution support.

Port of ``collie_tpu/parallel/distributed.py``.  ``collie_tpu`` runs JAX's
multi-controller model: every process runs the same program,
``jax.distributed.initialize`` connects them and one global ``Mesh`` spans
all processes.  The port's processes are connected by ``torch.distributed``
(one process a device), and a "global array" is each rank's slice of one
host array: ``put_global`` gives a rank the slice that a sharding spec
assigns it, and ``fetch`` all-gathers the slices back.  Every process must
hold the same full host arrays (``assert_same_across_processes`` checks it).

A sharding spec here is the tuple form of JAX's ``PartitionSpec``: one
entry a leading dimension, a mesh axis name (that dimension split evenly
over the axis, in the axis's rank order) or None; ``()`` is replicated.

Launch pattern (one process a device; the same script everywhere)::

    from collie_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize(coordinator_address='host0:1234',
                           num_processes=N, process_id=i)  # no-op if N == 1
    mesh = make_mesh(model=...)
    ids, scores = recommend(model, users, mesh=mesh)      # same on every rank

``all_reduce_sum`` and ``all_gather_cat`` are the collectives the mesh
paths call, one place to record their traffic.  ``gather_global`` /
``fetch`` bring a sharded tensor back whole; ``process_index``,
``process_count`` and ``barrier`` stand for JAX's process queries.
"""
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from collie_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size, mesh_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               **kwargs: Any) -> None:
    """Connect this process to the others: ``init_process_group``.

    A no-op when ``num_processes`` is 1 (so single-process scripts can call
    it unconditionally) or when the group is already initialized.
    ``coordinator_address`` is ``host:port`` (``tcp://`` is added) or any
    ``init_method`` URL (``file://...``); ``None`` reads the ``env://``
    variables.  ``backend`` (in ``kwargs``) defaults to NCCL where CUDA is
    available, else gloo; the other ``kwargs`` (``timeout``) go to
    ``init_process_group``.
    """
    if num_processes == 1 or dist.is_initialized():
        return
    init_method = coordinator_address
    if init_method is not None and '://' not in init_method:
        init_method = f'tcp://{init_method}'
    backend = kwargs.pop('backend', None) or ('nccl' if torch.cuda.is_available() else 'gloo')
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank in the group (``jax.process_index``); 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size (``jax.process_count``); 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process of the group (a no-op without one)."""
    if dist.is_initialized():
        dist.barrier()


def _local_index(shape: Sequence[int], mesh: DeviceMesh, spec: Sequence) -> tuple:
    """This rank's slice of an array of ``shape`` under ``spec``."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = axis_size(mesh, axis)
        if shape[dim] % n:
            raise ValueError(f'dimension {dim} ({shape[dim]}) does not divide the '
                             f'{axis!r} axis ({n})')
        rows = shape[dim] // n
        start = axis_index(mesh, axis) * rows
        index.append(slice(start, start + rows))
    return tuple(index)


def put_global(x, mesh: DeviceMesh, spec: Sequence = ()) -> torch.Tensor:
    """This rank's slice of the full host array ``x`` under ``spec``, on the
    mesh's device, a copy that keeps nothing else of ``x`` alive.  ``x``
    must be the same full array on every process."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x[_local_index(x.shape, mesh, spec)].to(mesh_device(mesh), copy=True)


def put_replicated(x, mesh: DeviceMesh) -> torch.Tensor:
    """The whole array on every rank."""
    return put_global(x, mesh, ())


def put_epoch_array(x, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """Split a host epoch array over the ``data`` axis on ``axis``;
    replicated when the dimension does not divide the axis."""
    x = np.asarray(x)
    n_data = axis_size(mesh, DATA_AXIS)
    if x.ndim > axis and x.shape[axis] % n_data == 0:
        spec = [None] * x.ndim
        spec[axis] = DATA_AXIS
        return put_global(x, mesh, spec)
    return put_replicated(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axis`` (``lax.psum``), a new
    contiguous tensor on the mesh's device (NCCL takes no other)."""
    out = x.to(mesh_device(mesh)).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def all_gather_cat(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in the axis's
    rank order (``lax.all_gather(..., tiled=True)``)."""
    x = x.to(mesh_device(mesh)).contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def fingerprint_arrays(*arrays) -> np.ndarray:
    """64-bit content fingerprint of host arrays (dtype + shape + bytes)."""
    import hashlib
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint64).copy()


def assert_same_across_processes(tag: str, *arrays) -> None:
    """Fail loudly if ``arrays`` differ between processes.

    ``put_global`` requires every process to hold the SAME full host array:
    a divergent copy (e.g. per-host shuffled datasets) would give each rank
    a slice of a different array.  A 64-bit fingerprint is all-gathered and
    compared.  No-op single-process.
    """
    if not is_multiprocess():
        return
    all_fp = [None] * dist.get_world_size()
    dist.all_gather_object(all_fp, int(fingerprint_arrays(*arrays)[0]))
    if any(v != all_fp[0] for v in all_fp):
        bad = [i for i, v in enumerate(all_fp) if v != all_fp[0]]
        raise ValueError(
            f'{tag} differs across processes (fingerprints {all_fp}, '
            f'mismatched process ids {bad}): every process must construct '
            'the identical dataset (same arrays, same order, same seed) '
            'before a multi-process run.')


def gather_global(x: torch.Tensor, mesh: Optional[DeviceMesh], spec: Sequence = ()) -> torch.Tensor:
    """The whole tensor whose slice on this rank under ``spec`` is ``x``:
    all-gathered over each sharded axis, on the mesh's device, in ``x``'s
    dtype (a bfloat16 tensor travels as float32, which holds it exactly).
    ``spec == ()`` returns ``x``."""
    dtype = x.dtype
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather_cat(x.float() if dtype == torch.bfloat16 else x, mesh, axis,
                               dim=dim).to(dtype)
    return x


def fetch(x, mesh: Optional[DeviceMesh] = None, spec: Sequence = ()) -> np.ndarray:
    """Bring a sharded tensor to the host (``gather_global``), bfloat16 as
    float32.  Replicated tensors (``spec == ()``) convert directly."""
    if isinstance(x, torch.Tensor):
        x = gather_global(x.detach(), mesh, spec).cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)
