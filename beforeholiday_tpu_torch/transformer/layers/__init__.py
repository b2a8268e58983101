"""Sequence-parallel-aware transformer layers (ref: apex/transformer/layers/)."""

from beforeholiday_tpu_torch.transformer.layers.layer_norm import (  # noqa: F401
    sp_fused_layer_norm,
    sp_fused_rms_norm,
)

__all__ = ["sp_fused_layer_norm", "sp_fused_rms_norm"]
