"""Data and model parallelism over ``torch.distributed``
(``pychain_tpu.parallel``'s port): one process per device, the batch's
rows spread over a mesh's ``dp`` dim and the models' annotated kernels
over its ``mp`` dim."""

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
from .model_parallel import (
    place_parameters,
    copy_to_mp,
    gather_from_mp,
    scatter_to_mp,
    reduce_from_mp,
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
    "place_parameters",
    "copy_to_mp",
    "gather_from_mp",
    "scatter_to_mp",
    "reduce_from_mp",
    "initialize",
    "global_dp_mesh",
    "host_local_batch_to_global",
    "replicate_to_global",
    "save_sharded",
    "restore_sharded",
]
