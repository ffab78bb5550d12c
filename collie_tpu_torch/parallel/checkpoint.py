"""Per-shard (distributed) checkpoints.

Port of ``collie_tpu/parallel/checkpoint.py``, in its on-disk layout.  A
``.shards`` directory holds:

* ``shards_p{k}.npz``, written by process ``k``: the shard data its device
  owns, one entry a distinct shard named ``{leaf}__{start_stop_step...}``
  (``_entry_name``: the leaf's index in the flattened tree, then each
  dimension's slice, ``n`` for None).  A shard held by several processes
  (a table replicated over ``data``, a replicated leaf) has ONE writer,
  chosen round-robin among its holders in the sorted order of the shards'
  indices, so the writing spreads over the processes;
* ``meta.pkl``, from process 0: ``skeleton`` (the tree, each leaf replaced
  by a placeholder that pickles as ``_make_leaf``), ``leaf_meta`` (per
  leaf ``('array', (shape, dtype, owners))`` or ``('host', value)``),
  ``host_payload`` (trainer counters, schedulers) and ``process_count``.

No full table is ever materialized, saving or loading.  A tree here is
nested dicts (flattened in sorted key order), lists and tuples (in order;
None is an empty node, as in JAX's tree utilities), with tensors as this
rank's shards: ``save_sharded_pytree``'s ``specs`` gives each tensor's
sharding spec (``distributed``'s tuple form; replicated by default).
Anything else is a host leaf.  A rank is at its coordinates in the mesh
(``mesh.mesh``); its process index is its rank.  bfloat16 tensors are
written as their uint16 bit pattern with the dtype ``'bfloat16'`` in the
metadata (the port has no ``ml_dtypes``).

``load_sharded_pytree`` reads this layout as the port writes it and as
collie_tpu writes it, without JAX: ``meta.pkl`` goes through the unpickler
of ``weights.read_checkpoint`` (optax's state classes as the stand-ins
there, ``ml_dtypes.bfloat16`` as the bit pattern), each rank reads the
entries of its own shard of every leaf, and when the mesh differs from the
one the checkpoint was saved on it assembles its shard from the overlapping
saved pieces.  Whether collie_tpu can read the port's ``.shards`` is out of
scope: the port's skeleton names the port's placeholder and plain
containers, not collie_tpu's and optax's classes.
"""
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from collie_tpu_torch.parallel.distributed import barrier, process_count, process_index
from collie_tpu_torch.parallel.sharding import global_shape
from collie_tpu_torch.weights import BF16_BITS, read_pickle

_META = 'meta.pkl'
_BF16 = 'bfloat16'


class _Leaf:
    """Pickle-stable placeholder marking array positions in the skeleton."""

    def __reduce__(self):
        return (_make_leaf, ())


def _make_leaf():
    return _LEAF


_LEAF = _Leaf()

# collie_tpu's skeleton names its own placeholder; both stand for this one
_META_GLOBALS = {('collie_tpu.parallel.checkpoint', '_make_leaf'): _make_leaf,
                 ('collie_tpu_torch.parallel.checkpoint', '_make_leaf'): _make_leaf}


def _index_key(index: Tuple) -> Tuple:
    """Hashable, pickle-stable key for a shard's index."""
    return tuple((s.start, s.stop, s.step) for s in index)


def _entry_name(leaf_i: int, key: Tuple) -> str:
    flat = '_'.join('n' if v is None else str(v) for se in key for v in se)
    return f'{leaf_i}__{flat}'


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` in JAX's tree order: dicts by sorted key, sequences
    (named tuples too) in order, None holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, '_fields', None)
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + ((fields[i] if fields else i),))]
    return [(path, tree)]


def _unflatten(skeleton: Any, leaves) -> Any:
    """``skeleton`` with its leaves taken from the iterator ``leaves``."""
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        filled = {k: _unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
        return {k: filled[k] for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        items = [_unflatten(v, leaves) for v in skeleton]
        if hasattr(skeleton, '_fields'):
            return type(skeleton)(*items)
        return type(skeleton)(items)
    return next(leaves)


def _skeleton(tree: Any) -> Any:
    return _unflatten(tree, iter([_LEAF] * len(_flatten(tree))))


def _coords(mesh) -> Dict[int, Dict[str, int]]:
    """Each rank's coordinate along each mesh axis."""
    if mesh is None:
        return {r: {} for r in range(process_count())}
    layout = mesh.mesh
    names = mesh.mesh_dim_names
    out = {}
    for position in np.ndindex(*layout.shape):
        out[int(layout[position])] = dict(zip(names, position))
    return out


def _shard_index(shape: Sequence[int], spec: Sequence, coords: Dict[str, int],
                 mesh) -> Tuple[slice, ...]:
    """The global slices of the shard at ``coords`` of an array of
    ``shape`` split by ``spec`` (JAX's index: ``slice(None)`` for a whole
    dimension)."""
    index = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            index.append(slice(None))
            continue
        rows = n // mesh.size(mesh.mesh_dim_names.index(axis))
        index.append(slice(coords[axis] * rows, (coords[axis] + 1) * rows))
    return tuple(index)


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, Any]:
    """A tensor as ``(numpy array, dtype for the metadata)``."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16).copy(), _BF16
    array = leaf.numpy().copy()
    return array, array.dtype


def save_sharded_pytree(dirpath, tree, host_payload: Optional[Dict] = None, mesh=None,
                        specs: Optional[Callable[[Tuple, torch.Tensor], Sequence]] = None
                        ) -> None:
    """Write ``tree``'s tensor leaves per shard under ``dirpath``.

    ``specs(path, tensor)`` gives each tensor leaf's spec on ``mesh``
    (``()``: replicated; the default for every leaf).  ``host_payload`` is
    any picklable dict stored in the metadata (trainer counters, scheduler
    state); it must be identical across processes (only process 0's copy
    is kept).  Every process calls this, and it returns once every file is
    complete."""
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    proc = process_index()
    coords = _coords(mesh)
    entries: Dict[str, np.ndarray] = {}
    leaf_meta = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        if not torch.is_tensor(leaf):
            leaf_meta.append(('host', leaf))
            continue
        spec = tuple(specs(path, leaf)) if specs is not None else ()
        shape = global_shape(leaf.shape, mesh, spec) if spec else tuple(leaf.shape)
        holders: Dict[Tuple, set] = {}
        for rank, at in coords.items():
            holders.setdefault(_index_key(_shard_index(shape, spec, at, mesh)), set()).add(rank)
        owners = {}
        for ordinal, key in enumerate(sorted(holders)):
            ranks = sorted(holders[key])
            owners[key] = ranks[ordinal % len(ranks)]
        mine = _index_key(_shard_index(shape, spec, coords[proc], mesh))
        array, dtype = _host_array(leaf)
        if owners[mine] == proc:
            entries[_entry_name(i, mine)] = array
        leaf_meta.append(('array', (shape, dtype, sorted(owners.items()))))
    np.savez(dirpath / f'shards_p{proc}.npz', **entries)
    if proc == 0:
        import pickle

        tmp = dirpath / (_META + '.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump({'skeleton': _skeleton(tree), 'leaf_meta': leaf_meta,
                         'host_payload': host_payload or {},
                         'process_count': process_count()}, f)
        tmp.rename(dirpath / _META)
    barrier()


def is_sharded_checkpoint(path) -> bool:
    return Path(path).is_dir() and (Path(path) / _META).exists()


def read_meta(dirpath) -> Dict[str, Any]:
    """The ``meta.pkl`` of a ``.shards`` directory of either package."""
    with open(Path(dirpath) / _META, 'rb') as f:
        return read_pickle(f, _META_GLOBALS)


def _is_bf16(dtype) -> bool:
    return isinstance(dtype, str) or type(dtype).__name__ == '_BFloat16Dtype'


def load_sharded_pytree(dirpath, shardings: Optional[Callable[[Tuple, Tuple], Sequence]] = None,
                        mesh=None) -> Tuple[Any, Dict]:
    """Rebuild this rank's shard of every leaf of the saved tree.

    ``shardings(path, shape)`` gives the spec on ``mesh`` of the array leaf
    at ``path`` of global ``shape`` (``()``: the whole array, the default).
    Returns ``(tree, host_payload)``: the saved tree (its containers as the
    metadata's unpickler gives them) with numpy arrays of this rank's
    shards at the array leaves, a bfloat16 leaf as ``{BF16_BITS: uint16
    bits}`` (``weights.device_leaf`` takes either).  Each rank reads only
    the entries its shards need."""
    dirpath = Path(dirpath)
    meta = read_meta(dirpath)
    skeleton, leaf_meta = meta['skeleton'], meta['leaf_meta']
    files = {}

    def npz(owner):
        if owner not in files:
            files[owner] = np.load(dirpath / f'shards_p{owner}.npz')
        return files[owner]

    placeholders = _flatten(skeleton)
    if len(placeholders) != len(leaf_meta):
        raise ValueError(f'skeleton has {len(placeholders)} leaves; metadata '
                         f'{len(leaf_meta)}')
    at = _coords(mesh)[process_index()] if mesh is not None else {}
    out = []
    try:
        for i, ((path, _), (kind, info)) in enumerate(zip(placeholders, leaf_meta)):
            if kind == 'host':
                out.append(info)
                continue
            shape, dtype, owners = info
            shape = tuple(shape)
            spec = tuple(shardings(path, shape)) if shardings is not None else ()
            want = _shard_index(shape, spec, at, mesh)
            owner = dict((tuple(k), o) for k, o in owners).get(_index_key(want))
            if owner is not None:
                piece = npz(owner)[_entry_name(i, _index_key(want))]
            else:
                piece = _assemble(i, shape, want, owners, npz)
            if _is_bf16(dtype):
                piece = {BF16_BITS: np.ascontiguousarray(piece).view(np.uint16)}
            out.append(piece)
    finally:
        for f in files.values():
            f.close()
    return _unflatten(skeleton, iter(out)), meta['host_payload']


def _assemble(leaf_i: int, shape: Tuple, want: Tuple[slice, ...], owners, npz) -> np.ndarray:
    """A shard whose index no saved entry has (the mesh differs from the
    one the checkpoint was saved on), from the overlapping saved pieces."""
    want = tuple(slice(s.start or 0, s.stop if s.stop is not None else dim)
                 for s, dim in zip(want, shape))
    buf = None
    for key, owner in owners:
        saved = tuple(slice(k[0] or 0, k[1] if k[1] is not None else dim)
                      for k, dim in zip(key, shape))
        inter = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                      for a, b in zip(want, saved))
        if any(s.start >= s.stop for s in inter):
            continue
        piece = npz(owner)[_entry_name(leaf_i, tuple(tuple(k) for k in key))]
        if buf is None:
            buf = np.empty([s.stop - s.start for s in want], piece.dtype)
        src = tuple(slice(s.start - sv.start, s.stop - sv.start) for s, sv in zip(inter, saved))
        dst = tuple(slice(s.start - w.start, s.stop - w.start) for s, w in zip(inter, want))
        buf[dst] = piece[src]
    return buf
