"""Megatron-style transformer pieces — counterpart of
``beforeholiday_tpu/transformer`` (ref: apex/transformer/).

Ported so far: the enums, ``functional.FusedScaleMaskSoftmax`` (the
unfused-attention path's softmax) and ``tensor_parallel.random`` (dropout
keys, dropout, activation checkpointing). Tensor, pipeline and context
parallelism and the rest of the JAX package's ``transformer`` are not
ported yet.
"""

from beforeholiday_tpu_torch.transformer import functional, tensor_parallel  # noqa: F401
from beforeholiday_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType", "functional",
           "tensor_parallel"]
