"""Functional transformer ops (ref: apex/transformer/functional/)."""

from beforeholiday_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax,
)
