"""Mesh construction, sharding rules, and multi-process execution.

The sharded-training half of ``collie_tpu.parallel`` (``checkpoint``,
``init_sharded_opt_states``) is not ported yet.
"""
from collie_tpu_torch.parallel import distributed
from collie_tpu_torch.parallel.embedding import shard_table, sharded_embedding_lookup
from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from collie_tpu_torch.parallel.sharding import (param_shardings,
                                                param_spec,
                                                shard_batch_fn,
                                                shard_params)

__all__ = [
    'DATA_AXIS', 'MODEL_AXIS', 'distributed', 'make_mesh',
    'param_shardings', 'param_spec', 'shard_batch_fn', 'shard_params',
    'shard_table', 'sharded_embedding_lookup',
]
