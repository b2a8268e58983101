"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers`` (the
part the O5 training steps run)."""

from beforeholiday_tpu_torch.optimizers.fused import (  # noqa: F401
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    MasterWeights,
    supports_flat_step,
)

__all__ = ["FusedAdam", "FusedLAMB", "FusedMixedPrecisionLamb",
           "MasterWeights", "supports_flat_step"]
