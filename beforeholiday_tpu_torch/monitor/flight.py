"""Flight recorder — counterpart of ``beforeholiday_tpu/monitor/flight.py``: a
bounded black box of the last N recorded steps, dumped as one structured
JSON when a run dies.

The recorder keeps the recent past on the host: a ring buffer
(``deque(maxlen=N)``) of step snapshots — a host row of metrics (a trainer's
drained metrics, or a serving scheduler's counters) plus rolled-up comms
and compile counter totals. It never reads a device value; the dump is its
one file write.

Triggers that turn the ring into an artifact:

* **StepGuard rollback trip** — :meth:`record` watches ``rollbacks_total``
  in the recorded rows; the step where it increments dumps automatically
  (``reason="stepguard_rollback"``).
* **Interpreter exit after an exception** — :meth:`arm_crash_dump` chains
  ``sys.excepthook`` (dump first, then the previous hook); using the
  recorder as a context manager dumps on the way out of a raising block and
  disarms on clean exit.
* **Preemption notice (opt-in)** — :meth:`arm_preemption_dump` installs a
  SIGTERM handler that dumps the ring plus the last durable checkpoint
  generation (:meth:`note_checkpoint`) and then re-delivers the signal, so
  the process still dies a signal death. When a graceful consumer is
  registered for the signal (:func:`register_preemption_consumer`, which
  ``elastic.PreemptionNotice`` does), the handler hands the notice to it
  after the dump instead: dump first, then the elastic loop drains.
* **An SLO breach** — the serving telemetry
  (``infer.telemetry.ServingTelemetry``) dumps the active recorder once
  per breached target.

The dump keeps the reference's schema key for key. ``dispatch_summary``
comes from ``monitor.counters`` (each op's kernel and plain-version
choices); ``probe_failures`` is always empty: it comes from the reference's
``guard/dispatch.py`` (probe a kernel, degrade to the plain path on
failure), which the port does not have by design — its wrappers launch
their kernel or raise — so no dispatch is ever degraded or probed.

Usage::

    with monitor.FlightRecorder(capacity=64, path="flight.json") as fr:
        for step in range(n):
            ...
            fr.record(step, row)         # host numbers only
    # a crash anywhere in the block -> flight.json holds the last 64 steps
"""

from __future__ import annotations

import collections
import json
import os
import signal as _signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from beforeholiday_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "FlightRecorder",
    "active_flight_recorder",
    "preemption_consumer",
    "register_preemption_consumer",
    "unregister_preemption_consumer",
]

# signum -> the graceful-drain consumer an armed preemption dump hands the
# notice to instead of re-delivering the signal
_PREEMPTION_CONSUMERS: Dict[int, Any] = {}
_CONSUMER_LOCK = threading.Lock()


def register_preemption_consumer(signum: int, callback) -> None:
    """Register ``callback(signum)`` as the graceful-drain consumer for
    ``signum``: an armed preemption dump for that signal dumps the black box
    and then notifies the consumer instead of re-delivering the signal."""
    with _CONSUMER_LOCK:
        _PREEMPTION_CONSUMERS[int(signum)] = callback


def unregister_preemption_consumer(signum: int, callback=None) -> None:
    """Remove the consumer for ``signum`` (with ``callback``, only if it is
    the registered one, so an uninstall cannot evict a newer notice)."""
    with _CONSUMER_LOCK:
        cur = _PREEMPTION_CONSUMERS.get(int(signum))
        if cur is None or (callback is not None and cur is not callback):
            return
        del _PREEMPTION_CONSUMERS[int(signum)]


def preemption_consumer(signum: int):
    """The registered consumer for ``signum`` (None: re-deliver)."""
    with _CONSUMER_LOCK:
        return _PREEMPTION_CONSUMERS.get(int(signum))


def _counter_totals() -> Dict[str, Any]:
    """Light per-snapshot rollup of the process-global counter state (host
    dict arithmetic only — every value is already a Python number)."""
    from beforeholiday_tpu_torch.monitor.comms import comms_records
    from beforeholiday_tpu_torch.monitor.compile import compile_counts
    from beforeholiday_tpu_torch.monitor.counters import dispatch_counters

    comms = comms_records()
    compiles = compile_counts().values()
    disp = dispatch_counters().values()
    return {
        "dispatch_pallas": sum(c["pallas"] for c in disp),
        "dispatch_jnp": sum(c["jnp"] for c in disp),
        "dispatch_probes": 0,
        "comms_calls": sum(r["calls"] for r in comms),
        "comms_bytes": sum(r["bytes"] for r in comms),
        "compile_signatures": sum(c["signatures"] for c in compiles),
        "compile_calls": sum(c["calls"] for c in compiles),
    }


class FlightRecorder:
    """Ring buffer of drained step snapshots + crash/rollback dump triggers.

    Parameters
    ----------
    capacity: ring size — how many recent steps the black box keeps.
    path: default dump destination (a per-dump override wins).
    auto_dump_on_rollback: dump when a recorded row's ``rollbacks_total``
        increments (the StepGuard trip); each trip dumps once.
    """

    def __init__(
        self,
        capacity: int = 64,
        *,
        path: str = "flight_recorder.json",
        auto_dump_on_rollback: bool = True,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self.auto_dump_on_rollback = bool(auto_dump_on_rollback)
        self.dumps: List[str] = []
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._prev_rollbacks: Optional[float] = None
        self._prev_hook = None
        self._armed = False
        self._last_checkpoint: Optional[Dict[str, Any]] = None
        self._sig_prev = None   # previous disposition while preemption-armed
        self._sig_num: Optional[int] = None

    # ------------------------------------------------------------- recording
    def record(
        self,
        step: int,
        row: Dict[str, Any],
        *,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one step to the ring. ``row`` is a HOST dict (numbers
        already fetched); counter totals are snapshotted alongside it.
        Detects the StepGuard rollback trip via ``rollbacks_total``
        increments."""
        snap: Dict[str, Any] = {
            "step": step,
            "metrics": dict(row),
            "counters": _counter_totals(),
        }
        if extra:
            snap["extra"] = dict(extra)
        rollbacks = row.get("rollbacks_total")
        tripped = False
        with self._lock:
            self._ring.append(snap)
            if rollbacks is not None:
                prev = self._prev_rollbacks
                tripped = prev is not None and rollbacks > prev
                self._prev_rollbacks = rollbacks
        if tripped and self.auto_dump_on_rollback:
            self.dump(reason="stepguard_rollback")

    def attach(self, metrics_logger) -> "FlightRecorder":
        """Chain into a metrics logger — any object with a ``callback(step,
        row)`` attribute, as the reference's ``MetricsLogger`` has: every
        drained row is recorded here before reaching the logger's existing
        callback. Returns self (so ``with FlightRecorder(...).attach(
        logger):`` reads naturally)."""
        prev_cb = metrics_logger.callback

        def _cb(step: int, row: Dict[str, Any]) -> None:
            self.record(step, row)
            if prev_cb is not None:
                prev_cb(step, row)

        metrics_logger.callback = _cb
        return self

    def note_checkpoint(self, generation: int,
                        path: Optional[str] = None) -> None:
        """Record the last DURABLE checkpoint generation (a checkpoint
        manager calls this as each generation lands). Rides every dump as
        ``last_checkpoint`` — a preemption dump thereby names exactly where
        the resumed run will pick up."""
        with self._lock:
            self._last_checkpoint = {
                "generation": int(generation),
                "path": path,
                "noted_unix": time.time(),
            }

    # -------------------------------------------------------------- queries
    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------- the dump
    def dump(
        self, path: Optional[str] = None, *, reason: str = "manual"
    ) -> str:
        """Write the black box: ring snapshots, loss-scale trajectory, the
        decoded last health state, and the dispatch, comms and compile
        summaries (the probe entry empty, see the module docstring). The
        module's one write path (host dicts only — nothing here reads a
        device value). Returns the path written."""
        from beforeholiday_tpu_torch.guard.step import health_summary
        from beforeholiday_tpu_torch.monitor.comms import comms_summary
        from beforeholiday_tpu_torch.monitor.compile import compile_summary
        from beforeholiday_tpu_torch.monitor.counters import dispatch_summary

        snaps = self.snapshots()
        with self._lock:
            last_ckpt = (
                dict(self._last_checkpoint) if self._last_checkpoint else None
            )
        payload: Dict[str, Any] = {
            "reason": reason,
            "created_unix": time.time(),
            "capacity": self.capacity,
            "last_checkpoint": last_ckpt,
            "n_snapshots": len(snaps),
            "snapshots": snaps,
            "loss_scale_trajectory": [
                s["metrics"].get("loss_scale") for s in snaps
            ],
            "last_health": (
                health_summary(snaps[-1]["metrics"]) if snaps else None
            ),
            "dispatch_summary": dispatch_summary(),
            "comms_summary": comms_summary(),
            "compile_summary": compile_summary(),
            "probe_failures": {},
        }
        out = path if path is not None else self.path
        with open(out, "w") as f:
            json.dump(payload, f)
        self.dumps.append(out)
        logger.warning(
            "flight recorder dumped %d step snapshot(s) to %s (reason=%s)",
            len(snaps), out, reason,
        )
        return out

    # ----------------------------------------------------------- crash hooks
    def arm_crash_dump(self) -> "FlightRecorder":
        """Chain ``sys.excepthook``: an uncaught exception dumps the black
        box (``reason="exception:<Type>"``) before the previous hook prints
        the traceback. Idempotent; :meth:`disarm_crash_dump` restores."""
        if self._armed:
            return self
        prev = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.dump(reason=f"exception:{exc_type.__name__}")
            except Exception:  # noqa: BLE001 — never mask the original crash
                logger.exception("flight-recorder dump failed in excepthook")
            prev(exc_type, exc, tb)

        self._prev_hook = prev
        sys.excepthook = _hook
        self._armed = True
        return self

    def arm_preemption_dump(self, signum: int = _signal.SIGTERM
                            ) -> "FlightRecorder":
        """Opt-in preemption hook: install a handler for ``signum`` (default
        SIGTERM — the shape of a cloud preemption notice) that dumps the
        black box (``reason="preemption:<SIGNAME>"``, including the last
        checkpoint generation from :meth:`note_checkpoint`) and then
        RE-DELIVERS the signal under the previous disposition — the process
        still dies a signal death (exit 143 for SIGTERM), so supervisors
        see the truthful status instead of a masked clean exit. With a
        graceful consumer registered for the signal
        (:func:`register_preemption_consumer`) the handler hands the notice
        to it after the dump and stays armed for a repeat notice. Main
        thread only (``signal.signal``'s contract); idempotent;
        :meth:`disarm_preemption_dump` restores."""
        if self._sig_num is not None:
            return self

        def _handler(s, frame):
            try:
                name = _signal.Signals(s).name
            except ValueError:  # pragma: no cover — exotic signum
                name = str(s)
            try:
                self.dump(reason=f"preemption:{name}")
            except Exception:  # noqa: BLE001 — never mask the signal
                logger.exception(
                    "flight-recorder dump failed in preemption handler"
                )
            consumer = preemption_consumer(s)
            if consumer is not None:
                try:
                    consumer(s)
                except Exception:  # noqa: BLE001 — fall through to death
                    logger.exception(
                        "graceful preemption consumer failed; re-delivering"
                    )
                else:
                    return
            prev = self._sig_prev
            self._sig_num = None
            self._sig_prev = None
            _signal.signal(
                s, prev if prev is not None else _signal.SIG_DFL
            )
            os.kill(os.getpid(), s)

        self._sig_prev = _signal.signal(signum, _handler)
        self._sig_num = signum
        return self

    def disarm_preemption_dump(self) -> None:
        """Restore the previous disposition for the armed signal (no-op when
        not armed)."""
        if self._sig_num is None:
            return
        prev = self._sig_prev
        _signal.signal(
            self._sig_num, prev if prev is not None else _signal.SIG_DFL
        )
        self._sig_num = None
        self._sig_prev = None

    def disarm_crash_dump(self) -> None:
        """Restore the previous excepthook (only if ours is still
        installed — a later hook chained on top is left alone)."""
        if not self._armed:
            return
        self._armed = False
        if self._prev_hook is not None and sys.excepthook.__qualname__.startswith(
            "FlightRecorder.arm_crash_dump"
        ):
            sys.excepthook = self._prev_hook
        self._prev_hook = None

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "FlightRecorder":
        global _ACTIVE
        self.arm_crash_dump()
        with _ACTIVE_LOCK:
            self._prev_active = _ACTIVE
            _ACTIVE = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self._prev_active
        self.disarm_crash_dump()
        if exc_type is not None:
            # the exception is handled (or about to propagate past the
            # excepthook we just removed) — dump here so the artifact exists
            # even when an outer try swallows the error
            try:
                self.dump(reason=f"exception:{exc_type.__name__}")
            except Exception:  # noqa: BLE001 — never mask the original error
                logger.exception("flight-recorder dump failed in __exit__")


# ------------------------------------------------------------ active recorder
_ACTIVE: Optional[FlightRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def active_flight_recorder() -> Optional[FlightRecorder]:
    """The recorder installed by the innermost ``with FlightRecorder(...)``
    block (None outside one) — for library code that wants to annotate the
    black box without threading a handle."""
    return _ACTIVE
