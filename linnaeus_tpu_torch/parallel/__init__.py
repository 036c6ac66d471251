"""More than one card: the (data, model) mesh, the collectives, the plans and
the GPipe pipeline (port of linnaeus_tpu/parallel/)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PARAM_SHARDING_FNS,
    Mesh,
    create_mesh,
    fsdp_param_sharding,
    initialize_multi_host,
    is_main_process,
    local_batch_slice,
    replicate,
    shard_batch,
)
from .ops import (  # noqa: F401
    DistributedContext,
    all_gather_object,
    all_gather_tensor,
    broadcast_host_value,
    get_rank_safely,
    get_world_size,
    master_only,
    reduce_tensor_mean,
    synchronize,
)
