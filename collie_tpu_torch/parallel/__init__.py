"""Mesh construction, sharding rules, multi-process execution and per-shard
checkpoints (the exports of ``collie_tpu.parallel``)."""
from collie_tpu_torch.parallel import checkpoint, distributed
from collie_tpu_torch.parallel.embedding import shard_table, sharded_embedding_lookup
from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from collie_tpu_torch.parallel.sharding import (init_sharded_opt_states,
                                                param_shardings,
                                                param_spec,
                                                shard_batch_fn,
                                                shard_params)

__all__ = [
    'DATA_AXIS', 'MODEL_AXIS', 'checkpoint', 'distributed',
    'init_sharded_opt_states', 'make_mesh',
    'param_shardings', 'param_spec', 'shard_batch_fn', 'shard_params',
    'shard_table', 'sharded_embedding_lookup',
]
