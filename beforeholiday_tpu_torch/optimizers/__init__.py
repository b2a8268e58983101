"""Fused optimizers — counterpart of ``beforeholiday_tpu/optimizers`` (the
fused optimizers, the master-weight wrapper, ZeRO-2's sharded optimizers
and the ZeRO-3 engine)."""

from beforeholiday_tpu_torch.optimizers.distributed_fused import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
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
from beforeholiday_tpu_torch.optimizers.zero3 import (  # noqa: F401
    Zero3Layout,
    ZeRO3FusedAdam,
    ZeRO3FusedLAMB,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB", "FusedAdagrad",
           "FusedAdam", "FusedLAMB", "FusedLARS", "FusedMixedPrecisionLamb",
           "FusedNovoGrad", "FusedSGD", "MasterWeights", "supports_flat_step",
           "Zero3Layout", "ZeRO3FusedAdam", "ZeRO3FusedLAMB"]
