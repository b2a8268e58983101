"""Pipeline parallelism (ref: apex/transformer/pipeline_parallel/)."""

from beforeholiday_tpu_torch.transformer.pipeline_parallel import p2p_communication  # noqa: F401
from beforeholiday_tpu_torch.transformer.pipeline_parallel.microbatches import (  # noqa: F401
    ConstantNumMicroBatches,
    RampupBatchsizeNumMicroBatches,
    build_num_microbatches_calculator,
)
from beforeholiday_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    EncDecPipelineGrads,
    PipelineGrads,
    activation_ring_depth,
    analytic_bubble_fraction,
    forward_backward_no_pipelining,
    forward_backward_pipelining_encoder_decoder,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    last_schedule_report,
    phase_counts,
    schedule_report,
)

__all__ = [
    "ConstantNumMicroBatches", "EncDecPipelineGrads", "PipelineGrads", "RampupBatchsizeNumMicroBatches",
    "activation_ring_depth", "analytic_bubble_fraction",
    "build_num_microbatches_calculator", "forward_backward_no_pipelining",
    "forward_backward_pipelining_encoder_decoder",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "get_forward_backward_func", "last_schedule_report", "p2p_communication",
    "phase_counts", "schedule_report",
]
