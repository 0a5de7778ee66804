"""Multi-process execution on torch.distributed (distributed.py) and the
process's devices with the block-sharded FM-index across them (mesh.py):
the port of the reference's arachne_tpu/parallel."""

from .distributed import (
    DistContext,
    allreduce_max_int,
    allreduce_stats,
    assert_uniform_int,
    init_distributed,
    partition_work,
    shard_suffix,
    shutdown_distributed,
)
from .mesh import (
    ShardedFMTables,
    make_mesh,
    pad_to_multiple,
    replicated_index_arrays,
    sharded_extend,
)

__all__ = [
    "DistContext",
    "ShardedFMTables",
    "allreduce_max_int",
    "allreduce_stats",
    "assert_uniform_int",
    "init_distributed",
    "make_mesh",
    "pad_to_multiple",
    "partition_work",
    "replicated_index_arrays",
    "shard_suffix",
    "sharded_extend",
    "shutdown_distributed",
]
