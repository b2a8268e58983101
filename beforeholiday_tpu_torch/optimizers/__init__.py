"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers`` (the
part the training steps run)."""

from beforeholiday_tpu_torch.optimizers.fused import (  # noqa: F401
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedSGD,
    MasterWeights,
    supports_flat_step,
)

__all__ = ["FusedAdam", "FusedLAMB", "FusedMixedPrecisionLamb", "FusedSGD",
           "MasterWeights", "supports_flat_step"]
