"""Explicitly sharded embedding lookup over the ``model`` mesh axis.

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
"""
import torch
from torch.distributed.device_mesh import DeviceMesh

from collie_tpu_torch.ops.embeddings import embedding_lookup
from collie_tpu_torch.parallel.distributed import all_reduce_sum, put_global
from collie_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size


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
