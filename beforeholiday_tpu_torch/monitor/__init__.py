"""Observability — counterpart of ``beforeholiday_tpu/monitor``, in part:
the signature gate and its counters (``compile``), trace spans (``spans``),
the collective-traffic ledger (``comms``), the host timeline recorder with
its Perfetto export (``trace``), mergeable latency histograms (``histo``)
and the crash flight recorder (``flight``)."""

from beforeholiday_tpu_torch.monitor import comms, spans, trace  # noqa: F401
from beforeholiday_tpu_torch.monitor.comms import (  # noqa: F401
    comms_records,
    comms_summary,
    ledger_scope,
    reset_comms_ledger,
)
from beforeholiday_tpu_torch.monitor.compile import (  # noqa: F401
    BucketGateError,
    compile_counts,
    compile_summary,
    reset_compile_counts,
    track_compiles,
)
from beforeholiday_tpu_torch.monitor.flight import (  # noqa: F401
    FlightRecorder,
    active_flight_recorder,
)
from beforeholiday_tpu_torch.monitor.histo import Histogram  # noqa: F401
from beforeholiday_tpu_torch.monitor.spans import annotate, span  # noqa: F401
from beforeholiday_tpu_torch.monitor.trace import (  # noqa: F401
    TraceRecorder,
    active_recorder,
    timeline,
)

__all__ = [
    "BucketGateError",
    "FlightRecorder",
    "Histogram",
    "TraceRecorder",
    "active_flight_recorder",
    "active_recorder",
    "annotate",
    "comms",
    "comms_records",
    "comms_summary",
    "compile_counts",
    "compile_summary",
    "ledger_scope",
    "reset_comms_ledger",
    "reset_compile_counts",
    "span",
    "spans",
    "timeline",
    "track_compiles",
]
