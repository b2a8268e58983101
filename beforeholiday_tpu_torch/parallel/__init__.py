"""Data-parallel building blocks — counterpart of ``beforeholiday_tpu/parallel``
(the single-device BatchNorm that ResNet runs and the LARC wrapper; DDP and
the cross-device SyncBN merge belong to a later slice)."""

from beforeholiday_tpu_torch.parallel.larc import LARC  # noqa: F401
from beforeholiday_tpu_torch.parallel.sync_batch_norm import (  # noqa: F401
    BatchNormParams,
    BatchNormState,
    init_batch_norm,
    sync_batch_norm,
)

__all__ = ["BatchNormParams", "BatchNormState", "LARC", "init_batch_norm",
           "sync_batch_norm"]
