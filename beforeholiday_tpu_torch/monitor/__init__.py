"""Training and serving observability — counterpart of
``beforeholiday_tpu/monitor``.

Split by which side of the device boundary each piece lives on:

* :mod:`~beforeholiday_tpu_torch.monitor.metrics`  — ``TrainMonitor`` and the
  ``Metrics`` dict: device-side counters, gauges and EMAs updated inside the
  step, with a ``torch.distributed`` cross-rank ``aggregate``.
* :mod:`~beforeholiday_tpu_torch.monitor.export`   — ``MetricsLogger``:
  host-side drain at a configurable cadence, one copy per logged step
  (JSONL / CSV / callback).
* :mod:`~beforeholiday_tpu_torch.monitor.spans`    — trace spans, profiler
  traces and timers (``utils/timers.py`` and ``utils/profiling.py`` remain
  as re-export shims).
* :mod:`~beforeholiday_tpu_torch.monitor.counters` — dispatch counters: each
  op's kernel and plain-version choices.
* :mod:`~beforeholiday_tpu_torch.monitor.comms`    — collective-traffic
  ledger (op kind / axis / dtype / bytes / call site, subsystem rollup).
* :mod:`~beforeholiday_tpu_torch.monitor.trace`    — host timeline recorder
  and its Chrome-trace/Perfetto ``trace.json`` export (``timeline``).
* :mod:`~beforeholiday_tpu_torch.monitor.compile`  — the signature gate and
  its counters (``track_compiles``).
* :mod:`~beforeholiday_tpu_torch.monitor.memory`   — per-entry memory
  ledger (``track_memory``: the CUDA allocator's peak on the card, the bytes
  saved for the backward on the CPU).
* :mod:`~beforeholiday_tpu_torch.monitor.roofline` — roofline/MFU ledger
  (``track_costs``: FLOPs from ``FlopCounterMode`` and the kernels' closed
  forms, joined with measured wall time; ``perf_report`` is the rollup).
* :mod:`~beforeholiday_tpu_torch.monitor.overlap`  — measured compute/comms
  overlap fraction and cross-rank straggler skew over the timeline.
* :mod:`~beforeholiday_tpu_torch.monitor.goodput`  — goodput classification
  of a timeline's wall time.
* :mod:`~beforeholiday_tpu_torch.monitor.flight`   — crash flight recorder.
* :mod:`~beforeholiday_tpu_torch.monitor.histo`    — mergeable latency
  histograms.
"""

# NOTE on the name ``trace``: importing the ``monitor.trace`` SUBMODULE sets
# the package attribute ``trace`` to the module; the spans import after it
# rebinds ``trace`` to the profiler context manager, the JAX package's
# public name. Code reaches the submodule by its full dotted path.
from beforeholiday_tpu_torch.monitor import comms, spans  # noqa: F401
from beforeholiday_tpu_torch.monitor.trace import (  # noqa: F401
    TraceRecorder,
    active_recorder,
    timeline,
)
from beforeholiday_tpu_torch.monitor.spans import (  # noqa: F401
    Timers,
    annotate,
    nvtx_range,
    span,
    start_trace,
    stop_trace,
    trace,
)
from beforeholiday_tpu_torch.monitor.metrics import (  # noqa: F401
    Metrics,
    TrainMonitor,
    global_norm,
)
from beforeholiday_tpu_torch.monitor.export import MetricsLogger  # noqa: F401
from beforeholiday_tpu_torch.monitor.counters import (  # noqa: F401
    dispatch_counters,
    dispatch_records,
    dispatch_summary,
    reset_counters,
    reset_dispatch_counters,
)
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
from beforeholiday_tpu_torch.monitor.memory import (  # noqa: F401
    measure_memory,
    memory_records,
    memory_summary,
    reset_memory_ledger,
    track_memory,
)
from beforeholiday_tpu_torch.monitor.roofline import (  # noqa: F401
    ChipSpec,
    chip_specs,
    estimate_costs,
    get_chip_spec,
    join_spans,
    measure_costs,
    perf_report,
    record_wall_time,
    register_chip_spec,
    reset_roofline_ledger,
    roofline_records,
    roofline_summary,
    track_costs,
)
from beforeholiday_tpu_torch.monitor.overlap import (  # noqa: F401
    overlap_report,
    rank_skew,
    span_intervals,
    straggler_report,
)
from beforeholiday_tpu_torch.monitor.flight import (  # noqa: F401
    FlightRecorder,
    active_flight_recorder,
)
from beforeholiday_tpu_torch.monitor.histo import Histogram  # noqa: F401
from beforeholiday_tpu_torch.monitor.goodput import (  # noqa: F401
    classify_span,
    goodput_report,
)

__all__ = [
    "BucketGateError",
    "ChipSpec",
    "FlightRecorder",
    "Histogram",
    "Metrics",
    "MetricsLogger",
    "Timers",
    "TraceRecorder",
    "TrainMonitor",
    "active_flight_recorder",
    "active_recorder",
    "annotate",
    "chip_specs",
    "classify_span",
    "comms",
    "comms_records",
    "comms_summary",
    "compile_counts",
    "compile_summary",
    "dispatch_counters",
    "dispatch_records",
    "dispatch_summary",
    "estimate_costs",
    "get_chip_spec",
    "global_norm",
    "goodput_report",
    "join_spans",
    "ledger_scope",
    "measure_costs",
    "measure_memory",
    "memory_records",
    "memory_summary",
    "nvtx_range",
    "overlap_report",
    "perf_report",
    "rank_skew",
    "record_wall_time",
    "register_chip_spec",
    "reset_comms_ledger",
    "reset_compile_counts",
    "reset_counters",
    "reset_dispatch_counters",
    "reset_memory_ledger",
    "reset_roofline_ledger",
    "roofline_records",
    "roofline_summary",
    "span",
    "span_intervals",
    "spans",
    "start_trace",
    "stop_trace",
    "straggler_report",
    "timeline",
    "trace",
    "track_compiles",
    "track_costs",
    "track_memory",
]
