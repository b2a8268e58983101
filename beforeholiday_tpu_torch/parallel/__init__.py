"""Data-parallel layer — counterpart of ``beforeholiday_tpu/parallel``:
process-group state, gradient reduction (DDP, bucketed and compressed,
backward-time hooks), (Sync)BatchNorm and LARC, over ``torch.distributed``
(NCCL on the card, gloo on the CPU)."""

from beforeholiday_tpu_torch.parallel import (  # noqa: F401
    bucketing,
    overlap,
    parallel_state,
)
from beforeholiday_tpu_torch.parallel.bucketing import (  # noqa: F401
    DEFAULT_BUCKET_BYTES,
    BucketedReduce,
)
from beforeholiday_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    check_replicated_consistency,
    reduce_gradients,
)
from beforeholiday_tpu_torch.parallel.larc import LARC  # noqa: F401
from beforeholiday_tpu_torch.parallel.overlap import (  # noqa: F401
    hook_tree,
    reduction_hook,
)
from beforeholiday_tpu_torch.parallel.parallel_state import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    EXPERT_AXIS,
    PIPE_AXIS,
    TENSOR_AXIS,
    destroy_model_parallel,
    initialize_model_parallel,
    model_parallel_is_initialized,
)
from beforeholiday_tpu_torch.parallel.sync_batch_norm import (  # noqa: F401
    BatchNormParams,
    BatchNormState,
    init_batch_norm,
    sync_batch_norm,
)

__all__ = [
    "parallel_state", "bucketing", "overlap", "BucketedReduce",
    "DEFAULT_BUCKET_BYTES", "DistributedDataParallel", "Reducer",
    "check_replicated_consistency", "reduce_gradients", "reduction_hook",
    "hook_tree", "LARC", "BatchNormParams", "BatchNormState",
    "init_batch_norm", "sync_batch_norm", "initialize_model_parallel",
    "destroy_model_parallel", "model_parallel_is_initialized", "DATA_AXIS",
    "TENSOR_AXIS", "PIPE_AXIS", "CONTEXT_AXIS", "EXPERT_AXIS",
]
