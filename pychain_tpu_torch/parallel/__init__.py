"""Data parallelism over ``torch.distributed`` (``pychain_tpu.parallel``'s
port): one process per device, the batch's rows spread over the ranks."""

from .data_parallel import (
    make_mesh,
    shard_batch,
    engine_pspec,
    pjit_chain_function,
    ShardedChainLoss,
    global_value,
    sum_gradients,
    all_ranks,
)
from .multihost import (
    initialize,
    global_dp_mesh,
    host_local_batch_to_global,
    replicate_to_global,
    save_sharded,
    restore_sharded,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "engine_pspec",
    "pjit_chain_function",
    "ShardedChainLoss",
    "global_value",
    "sum_gradients",
    "all_ranks",
    "initialize",
    "global_dp_mesh",
    "host_local_batch_to_global",
    "replicate_to_global",
    "save_sharded",
    "restore_sharded",
]
