"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers`` (the
fused optimizers and the master-weight wrapper)."""

from beforeholiday_tpu_torch.optimizers.fused import (  # noqa: F401
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
    MasterWeights,
    supports_flat_step,
)

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB", "FusedLARS",
           "FusedMixedPrecisionLamb", "FusedNovoGrad", "FusedSGD",
           "MasterWeights", "supports_flat_step"]
