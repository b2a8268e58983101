"""Shared utilities — counterpart of ``beforeholiday_tpu/utils``:
rank-annotated logging and ``warn_once``; timers and profiling live in
:mod:`beforeholiday_tpu_torch.monitor.spans` (re-exported here)."""

from beforeholiday_tpu_torch.utils.logging import get_logger, reset_warn_once, warn_once
from beforeholiday_tpu_torch.utils.profiling import annotate, nvtx_range, trace
from beforeholiday_tpu_torch.utils.timers import Timers

__all__ = [
    "get_logger",
    "Timers",
    "annotate",
    "nvtx_range",
    "reset_warn_once",
    "trace",
    "warn_once",
]
