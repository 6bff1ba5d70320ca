"""Multi-process data parallelism on ``torch.distributed`` (the port of
``nnest_tpu.parallel``; tensor parallelism is not ported)."""

from nnest_torch.parallel.mesh import (
    Mesh, all_reduce_sum, batch_sharding, broadcast_exact, gather_rows,
    get_mesh, initialize_distributed, params_sharding_tree, replicated,
    shard_batch, shard_params)
from nnest_torch.parallel.sharded import (
    make_sharded_mcmc, make_sharded_train_step)

__all__ = [
    'initialize_distributed', 'get_mesh', 'batch_sharding', 'replicated',
    'shard_batch', 'params_sharding_tree', 'shard_params',
    'make_sharded_train_step', 'make_sharded_mcmc', 'broadcast_exact',
    'Mesh', 'gather_rows', 'all_reduce_sum',
]
