"""Host-side timeline recorder + Chrome-trace/Perfetto ``trace.json`` export —
counterpart of ``beforeholiday_tpu/monitor/trace.py``.

A wall-clock event recorder whose output loads directly in Perfetto or
``chrome://tracing`` (the JSON Trace Event Format). It shows host activity:
the scheduler's steps, each request's lifecycle (the serving telemetry books
them here) and counter tracks. Device timelines are ``torch.profiler``'s
job; the two views compose.

Layout: one Chrome-trace *process* row per rank (``pid`` = rank; process
metadata names the row), one *thread* row per recording host thread. Spans
are ``B``/``E`` begin/end pairs (they nest per pid/tid), instants are ``i``
events, counters ``C`` events.

Usage::

    with monitor.timeline("trace.json") as rec:
        batcher.run()                # telemetry spans land in rec
        rec.instant("ckpt_saved")
    # exported on exit; open trace.json in Perfetto
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "TraceRecorder",
    "active_recorder",
    "timeline",
]


class TraceRecorder:
    """Append-only host event recorder in Chrome trace-event form.

    Thread-safe; timestamps are ``time.perf_counter_ns`` microseconds
    relative to construction (Chrome traces want microseconds)."""

    def __init__(self, *, process_name: str = "beforeholiday_tpu_torch"):
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pids: Dict[int, int] = {}  # rank -> pid (identity; dedup only)
        self._tids: Dict[int, int] = {}  # thread ident -> small tid
        self._named_threads: set = set()  # (pid, tid) rows already named
        self._process_name = process_name

    # ------------------------------------------------------------- internals
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _pid_tid(self, rank: int):
        """Register (and name) the rank's process row and this thread's
        thread row on first use. Caller holds no lock."""
        ident = threading.get_ident()
        with self._lock:
            if rank not in self._pids:
                self._pids[rank] = rank
                self._events.append({
                    "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
                    "args": {"name": f"{self._process_name} rank {rank}"},
                })
                self._events.append({
                    "ph": "M", "name": "process_sort_index", "pid": rank,
                    "tid": 0, "args": {"sort_index": rank},
                })
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            tid = self._tids[ident]
            if (rank, tid) not in self._named_threads:
                # name every (process, thread) row so multi-rank traces load
                # with deterministic, human-readable rows in Perfetto (tid 0
                # is each rank's main recording thread)
                self._named_threads.add((rank, tid))
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": rank,
                    "tid": tid, "args": {"name": f"host-thread-{tid}"},
                })
                self._events.append({
                    "ph": "M", "name": "thread_sort_index", "pid": rank,
                    "tid": tid, "args": {"sort_index": tid},
                })
        return rank, tid

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------ recording
    def begin(self, name: str, *, rank: int = 0,
              args: Optional[Dict[str, Any]] = None) -> None:
        pid, tid = self._pid_tid(rank)
        ev = {"ph": "B", "name": name, "pid": pid, "tid": tid,
              "ts": self._now_us()}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def end(self, *, rank: int = 0) -> None:
        pid, tid = self._pid_tid(rank)
        self._append({"ph": "E", "pid": pid, "tid": tid, "ts": self._now_us()})

    @contextlib.contextmanager
    def span(self, name: str, *, rank: int = 0,
             args: Optional[Dict[str, Any]] = None):
        """Nested host span (``B``/``E`` pair)."""
        self.begin(name, rank=rank, args=args)
        try:
            yield
        finally:
            self.end(rank=rank)

    def instant(self, name: str, *, rank: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Zero-duration marker."""
        pid, tid = self._pid_tid(rank)
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": self._now_us(), "s": "t"}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def counter(self, name: str, value: Any, *, rank: int = 0) -> None:
        """Counter-track sample (``C`` event): Perfetto renders one stacked
        area chart per (pid, name) from these — the serving telemetry books
        page occupancy, batch fill, and admission-queue depth this way.
        ``value`` may be a number or a dict of series-name → number (multi-
        series counters stack)."""
        pid, tid = self._pid_tid(rank)
        series = dict(value) if isinstance(value, dict) else {"value": value}
        self._append({
            "ph": "C", "name": name, "pid": pid, "tid": tid,
            "ts": self._now_us(),
            "args": {k: float(v) for k, v in series.items()},
        })

    # -------------------------------------------------------------- queries
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the raw event list (host dicts; no device values)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def _export_events(self) -> List[Dict[str, Any]]:
        """Deterministic export order: all ``M`` metadata rows first, sorted
        by (pid, tid, name) so Perfetto assigns process/thread rows the same
        order on every load, then the timed events sorted by timestamp
        (stable — simultaneous events keep recording order)."""
        events = self.events()
        meta = [e for e in events if e.get("ph") == "M"]
        timed = [e for e in events if e.get("ph") != "M"]
        meta.sort(key=lambda e: (e.get("pid", 0), e.get("tid", 0),
                                 e.get("name", "")))
        timed.sort(key=lambda e: e.get("ts", 0.0))
        return meta + timed

    # --------------------------------------------------------------- export
    def export(self, path: str) -> None:
        """Write ``{"traceEvents": [...]}`` — loads in Perfetto /
        ``chrome://tracing`` as-is (metadata rows first, timed events in
        timestamp order — see ``_export_events``). The module's one
        write path (host-side data only)."""
        payload = {
            "traceEvents": self._export_events(),
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f)


# ------------------------------------------------------- active recorder
# Process-global by design, like warn_once: the serving telemetry fires from
# inside the scheduler, which cannot thread a recorder handle.
_ACTIVE: Optional[TraceRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def active_recorder() -> Optional[TraceRecorder]:
    """The recorder installed by ``timeline`` (None when not recording)."""
    return _ACTIVE


@contextlib.contextmanager
def timeline(path: Optional[str] = None, *,
             recorder: Optional[TraceRecorder] = None):
    """Install a recorder as process-active for the block; export to ``path``
    on exit when given. Yields the recorder. Re-entrant (the previous
    recorder is restored), though nested timelines record independently."""
    global _ACTIVE
    rec = recorder if recorder is not None else TraceRecorder()
    with _ACTIVE_LOCK:
        prev = _ACTIVE
        _ACTIVE = rec
    try:
        yield rec
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
        if path is not None:
            rec.export(path)
