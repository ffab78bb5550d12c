"""Explicitly sharded embedding lookup over the ``model`` mesh axis, and
the tables of a mesh training step.

Port of ``collie_tpu/parallel/embedding.py``.  Each rank holds rows
``[shard * rows_per_shard, (shard + 1) * rows_per_shard)`` of a table; a
lookup of ids replicated over ``model``:

1. gathers the ids clipped to the local range through
   ``ops.embeddings.embedding_lookup`` (so a bfloat16 table's gradient
   still sums its collisions in float32);
2. zeroes the rows of ids outside the local range;
3. sums the partial rows over the ``model`` axis.

Communication is ``O(batch x dim)`` (the activations), never ``O(table)``.
The sum's backward passes the cotangent through unchanged: every rank's
output cotangent is the replicated one, so the table gradient is the local
scatter of it, as under JAX's ``psum`` in ``shard_map``.  (An all-reduce in
the backward, as ``torch.distributed.nn``'s does, would make it ``n_model``
times the dense gradient.)

**Mesh training** (``ShardedTable``, ``TableGrads``).  JAX's mesh step is
one GSPMD program; the port's runs on every rank over the rank's ``data``
slice of the step's batch, and must still compute the single-device step.
The engine hands ``calculate_loss`` each table that the models read by id
(``sharding.is_id_table``) as a ``ShardedTable``: whatever form the model's
code reads it in (``embedding_lookup(table, ids)``, ``table[ids]``,
``table.to(torch.bfloat16)[ids]``), the read is the sharded lookup above,
and the rows it gathers are recorded on the step's ``TableGrads`` as
leaves of their own.  Autograd stops at those rows: after the backward,
``TableGrads.table_gradients`` sums each table's row cotangents into its
shard once, in float32 (rounded once to a bfloat16 table's dtype), and adds
the other ``data`` ranks' contributions with one collective a table, the
cheaper of two chosen from static shapes:

* an all-gather over ``data`` of the looked-up local ids and their row
  cotangents, then a local scatter-add: ``R_batch x width`` floats (and
  ``R_batch`` int32 ids) a rank, ``R_batch`` the rows the global step
  looks up in the table;
* a dense all-reduce over ``data`` of the locally summed shard gradient:
  ``R_shard x width`` floats.

So no exchange moves more than ``min(R_shard, R_batch) x width`` floats a
table.  Within a ``data`` group the ``model`` ranks need no exchange: the
sum's pass-through backward already gives each its rows' cotangents.
"""
from typing import Dict, List, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from collie_tpu_torch.ops.embeddings import embedding_lookup
from collie_tpu_torch.parallel.distributed import all_gather_cat, all_reduce_sum, put_global
from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size


class _SumOverAxis(torch.autograd.Function):
    """``all_reduce_sum`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
        ctx.device = x.device
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.device), None, None


def sharded_embedding_lookup(table_shard: torch.Tensor,
                             ids: torch.Tensor,
                             mesh: DeviceMesh) -> torch.Tensor:
    """``table[ids]`` where this rank holds ``table_shard``, its row shard
    of ``table`` (``shard_table``).

    ``ids [...]`` global row ids, the same on every ``model`` rank ->
    ``[..., dim]`` float32 (``[...]`` for a 1-D table), the same on every
    ``model`` rank.
    """
    rows_per_shard = table_shard.shape[0]
    start = axis_index(mesh, MODEL_AXIS) * rows_per_shard
    local = ids - start
    in_range = (local >= 0) & (local < rows_per_shard)
    rows = embedding_lookup(table_shard, local.clamp(0, rows_per_shard - 1))
    in_range = in_range.reshape(in_range.shape + (1,) * (rows.dim() - in_range.dim()))
    rows = torch.where(in_range, rows, torch.zeros_like(rows))
    return _SumOverAxis.apply(rows, mesh, MODEL_AXIS)


def shard_table(table: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's row shard of ``table`` over the ``model`` axis."""
    n_shards = axis_size(mesh, MODEL_AXIS)
    if table.shape[0] % n_shards:
        raise ValueError(f'table rows ({table.shape[0]}) must divide the model axis '
                         f'({n_shards}); pad the table or replicate it instead')
    return put_global(table, mesh, (MODEL_AXIS,) + (None,) * (table.dim() - 1))


def lookup_for_shards(source: torch.Tensor, source_sharded: bool, ids: torch.Tensor,
                      target_sharded: bool, mesh: DeviceMesh) -> torch.Tensor:
    """``table[ids]`` for the ``[N]`` global ``ids`` of a table that is
    split like a target of ``N`` rows: this rank's row shard of the result
    when ``target_sharded``, else all of it.  ``source`` is this rank's row
    shard of ``table`` when ``source_sharded``, else the whole table.

    A sharded source is read by ``sharded_embedding_lookup``, one ``model``
    rank's rows after another, so no rank ever holds more than a shard of
    the source or of the result."""
    if not source_sharded:
        rows = ids.shape[0] // axis_size(mesh, MODEL_AXIS) if target_sharded else ids.shape[0]
        start = axis_index(mesh, MODEL_AXIS) * rows if target_sharded else 0
        return source[ids[start:start + rows]]
    if not target_sharded:
        return sharded_embedding_lookup(source, ids, mesh).to(source.dtype)
    n_model = axis_size(mesh, MODEL_AXIS)
    rows = ids.shape[0] // n_model
    mine = None
    for shard in range(n_model):
        part = sharded_embedding_lookup(source, ids[shard * rows:(shard + 1) * rows], mesh)
        if shard == axis_index(mesh, MODEL_AXIS):
            mine = part.to(source.dtype)
    return mine


class TableGrads:
    """One mesh training step's record of its table lookups and the
    ``data``-axis exchange of their gradients (module docstring)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._entries: Dict[str, List] = {}

    def record(self, key: str, local_ids: torch.Tensor, rows: torch.Tensor) -> None:
        self._entries.setdefault(key, []).append((local_ids, rows))

    def row_leaves(self) -> List[torch.Tensor]:
        """The recorded rows, the leaves to differentiate, in record order."""
        return [rows for entries in self._entries.values() for _, rows in entries]

    def table_gradients(self, row_grads: Sequence[Optional[torch.Tensor]],
                        shards: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each recorded table's gradient on this rank's shard, summed over
        the step's ``data`` ranks, from ``row_grads`` (the gradients of
        ``row_leaves()``, in order).  A table none of whose rows reached the
        loss is left out.  Every rank records the same lookups at the same
        shapes, so every rank takes the same collectives (at a ``data`` axis
        of one too, where they copy)."""
        n_data = axis_size(self.mesh, DATA_AXIS)
        grads = iter(row_grads)
        out = {}
        for key, entries in self._entries.items():
            ids, rows = [], []
            for local_ids, _ in entries:
                grad = next(grads)
                if grad is not None:
                    ids.append(local_ids.reshape(-1))
                    rows.append(grad.float().reshape(local_ids.numel(), -1))
            if not ids:
                continue
            shard = shards[key]
            ids, rows = (ids[0], rows[0]) if len(ids) == 1 else (torch.cat(ids), torch.cat(rows))
            acc = torch.zeros((shard.shape[0], rows.shape[1]), dtype=torch.float32,
                              device=rows.device)
            if n_data * ids.numel() < shard.shape[0]:
                ids = all_gather_cat(ids.to(torch.int32), self.mesh, DATA_AXIS).long()
                rows = all_gather_cat(rows, self.mesh, DATA_AXIS)
                acc.index_put_((ids,), rows, accumulate=True)
            else:
                acc.index_put_((ids,), rows, accumulate=True)
                acc = all_reduce_sum(acc, self.mesh, DATA_AXIS)
            out[key] = acc.reshape(shard.shape).to(shard.dtype)
        return out


class ShardedTable:
    """A table a mesh training step reads by id: this rank's row shard of
    it (``sharded``) or the whole table, standing in for the tensor in the
    params dict that ``calculate_loss`` sees (module docstring).

    ``table[ids]`` keeps the table's dtype, as indexing a tensor does;
    ``embedding_lookup(table, ids)`` (``lookup``) gives float32 rows;
    ``table.to(dtype)`` converts the shard.  Any other use raises, so no
    model reads a shard as if it were the table."""

    def __init__(self, shard: torch.Tensor, mesh: DeviceMesh, sharded: bool,
                 tape: Optional[TableGrads] = None, key: Optional[str] = None):
        self.shard = shard.detach()
        self.mesh = mesh
        self.sharded = sharded
        self.start = axis_index(mesh, MODEL_AXIS) * shard.shape[0] if sharded else 0
        self.tape = tape
        self.key = key

    def to(self, *args, **kwargs) -> 'ShardedTable':
        return ShardedTable(self.shard.to(*args, **kwargs), self.mesh, self.sharded,
                            self.tape, self.key)

    def __getitem__(self, ids) -> torch.Tensor:
        if not torch.is_tensor(ids) or ids.is_floating_point() or ids.dtype == torch.bool:
            raise TypeError('a sharded table is read by integer id tensors only')
        return self.lookup(ids).to(self.shard.dtype)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """float32 rows of the global ``ids``, the same on every ``model``
        rank; their gradient is recorded on the tape (when there is one and
        autograd is on)."""
        local = ids
        if self.sharded:
            rows_here = self.shard.shape[0]
            local = ids - self.start
            in_range = (local >= 0) & (local < rows_here)
            local = local.clamp(0, rows_here - 1)
        rows = self.shard[local].float()
        if self.tape is not None and torch.is_grad_enabled():
            rows.requires_grad_()           # a fresh tensor: the index made it
            self.tape.record(self.key, local, rows)
        if not self.sharded:
            return rows
        in_range = in_range.reshape(in_range.shape + (1,) * (rows.dim() - in_range.dim()))
        rows = torch.where(in_range, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return _SumOverAxis.apply(rows, self.mesh, MODEL_AXIS)
