"""Multi-process data and tensor parallelism on ``torch.distributed`` (the
port of ``nnest_tpu.parallel``): a (dp, tp) mesh of ranks, dp-sharded
batches and, with tp > 1, the flow's wide conditioner weights
column-sharded over the tp group."""

from nnest_torch.parallel.mesh import (
    ColumnShard, Mesh, all_reduce_sum, batch_sharding, broadcast_exact,
    gather_rows, get_mesh, initialize_distributed, params_sharding_tree,
    replicated, shard_batch, shard_params, unshard)
from nnest_torch.parallel.sharded import (
    make_sharded_mcmc, make_sharded_train_step)

__all__ = [
    'initialize_distributed', 'get_mesh', 'batch_sharding', 'replicated',
    'shard_batch', 'params_sharding_tree', 'shard_params',
    'make_sharded_train_step', 'make_sharded_mcmc', 'broadcast_exact',
    'Mesh', 'gather_rows', 'all_reduce_sum', 'ColumnShard', 'unshard',
]
