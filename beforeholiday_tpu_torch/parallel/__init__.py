"""Data-parallel layer — counterpart of ``beforeholiday_tpu/parallel``:
process-group state and the mesh carvers, gradient reduction (DDP,
bucketed, compressed and two-level, backward-time hooks, the
optimizer-in-backward flags), (Sync)BatchNorm and LARC, over
``torch.distributed`` (NCCL on the card, gloo on the CPU)."""

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
    fold_found_inf,
    hook_tree,
    per_bucket_found_inf,
    reduction_hook,
)
from beforeholiday_tpu_torch.parallel.parallel_state import (  # noqa: F401
    CONTEXT_AXIS,
    DATA_AXIS,
    EXPERT_AXIS,
    HIERARCHICAL_AXES,
    INTRA_AXIS,
    PIPE_AXIS,
    SLICE_AXIS,
    TENSOR_AXIS,
    Mesh,
    carve_data_mesh,
    destroy_model_parallel,
    initialize_model_parallel,
    make_moe_mesh,
    make_two_level_mesh,
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
    "hook_tree", "per_bucket_found_inf", "fold_found_inf", "LARC", "BatchNormParams", "BatchNormState",
    "init_batch_norm", "sync_batch_norm", "initialize_model_parallel",
    "destroy_model_parallel", "model_parallel_is_initialized", "DATA_AXIS",
    "TENSOR_AXIS", "PIPE_AXIS", "CONTEXT_AXIS", "EXPERT_AXIS", "SLICE_AXIS",
    "INTRA_AXIS", "HIERARCHICAL_AXES", "Mesh", "make_two_level_mesh",
    "make_moe_mesh", "carve_data_mesh",
]
