"""Megatron-style transformer pieces — counterpart of
``beforeholiday_tpu/transformer`` (ref: apex/transformer/).

``tensor_parallel``: the TP/SP mappings, layers, vocab-parallel cross
entropy, data broadcast, memory buffers and the RNG discipline.
``pipeline_parallel``: the schedules, microbatch calculators and stage
communication. ``layers``: the sequence-parallel-aware norms.
``amp_grad_scaler``: the model-parallel found-inf reduction. ``functional``:
``FusedScaleMaskSoftmax``. ``_data``: the pretraining batch samplers.
``context_parallel``: ring attention over the context group.
``parallel_state`` lives in ``beforeholiday_tpu_torch.parallel``.
"""

from beforeholiday_tpu_torch.transformer import (  # noqa: F401
    _data,
    context_parallel,
    functional,
    layers,
    pipeline_parallel,
    tensor_parallel,
)
from beforeholiday_tpu_torch.transformer.amp_grad_scaler import (  # noqa: F401
    GradScaler,
    reduce_found_inf,
)
from beforeholiday_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

__all__ = ["AttnMaskType", "AttnType", "GradScaler", "LayerType", "ModelType",
           "context_parallel", "functional", "layers", "pipeline_parallel", "reduce_found_inf",
           "tensor_parallel"]
