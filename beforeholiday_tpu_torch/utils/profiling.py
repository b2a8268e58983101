"""Back-compat shim — the profiling hooks live in
:mod:`beforeholiday_tpu_torch.monitor.spans`; this module re-exports the JAX
package's ``utils/profiling.py`` surface."""

from __future__ import annotations

from beforeholiday_tpu_torch.monitor.spans import (  # noqa: F401
    annotate,
    nvtx_range,
    span,
    start_trace,
    stop_trace,
    trace,
)

__all__ = ["annotate", "nvtx_range", "span", "start_trace", "stop_trace", "trace"]
