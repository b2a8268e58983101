"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers`` (the
part the O5 training step runs)."""

from beforeholiday_tpu_torch.optimizers.fused import (  # noqa: F401
    FusedAdam,
    MasterWeights,
    supports_flat_step,
)

__all__ = ["FusedAdam", "MasterWeights", "supports_flat_step"]
