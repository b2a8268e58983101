"""Shared utilities — counterpart of ``beforeholiday_tpu/utils``, in part:
rank-annotated logging. Timers and profiling ranges live in
:mod:`beforeholiday_tpu_torch.monitor.spans`."""

from beforeholiday_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger"]
