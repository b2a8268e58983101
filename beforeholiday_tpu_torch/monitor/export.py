"""Host-side metrics export — counterpart of
``beforeholiday_tpu/monitor/export.py``: the ONE sanctioned readback per
logged step.

* the step returns the packed metrics vector (``TrainMonitor.pack``)
  alongside its outputs — one extra output, no extra sync;
* ``MetricsLogger.log`` is called every step but touches the host only on
  the configured cadence (``every``); off-cadence steps cost nothing;
* on-cadence, ``drain`` copies that one vector to the host (ONE
  device-to-host copy, which waits for the step that made it) and fans it
  out to JSONL/CSV writers and a callback.

Everything device-side lives in ``monitor/metrics.py``.
"""

from __future__ import annotations

import atexit
import csv
import json
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from beforeholiday_tpu_torch.monitor.histo import Histogram
from beforeholiday_tpu_torch.monitor.metrics import Metrics, TrainMonitor
from beforeholiday_tpu_torch.utils.logging import get_logger, warn_once

logger = get_logger(__name__)

Row = Dict[str, Union[int, float]]


class MetricsLogger:
    """Drain the metrics at a configurable cadence.

    Parameters
    ----------
    monitor: the ``TrainMonitor`` whose pack order defines the row schema.
    path: optional output file; format chosen by ``fmt`` ("jsonl" | "csv").
    every: cadence in steps — ``log`` drains on ``step % every == 0`` and is
        a no-op (not even a copy) otherwise.
    callback: optional ``fn(step, row)`` hook invoked per drained row.
    warn_overflow_streak: emit a (rate-limited, once per incident) warning
        when the drained ``consecutive_overflows`` reaches this value;
        ``0`` disables.
    """

    def __init__(
        self,
        monitor: TrainMonitor,
        *,
        path: Optional[str] = None,
        fmt: str = "jsonl",
        every: int = 1,
        callback: Optional[Callable[[int, Row], None]] = None,
        warn_overflow_streak: int = 3,
    ):
        assert fmt in ("jsonl", "csv"), f"unknown fmt {fmt!r}"
        assert every >= 1, "every must be >= 1"
        self.monitor = monitor
        self.path = path
        self.fmt = fmt
        self.every = int(every)
        self.callback = callback
        self.warn_overflow_streak = int(warn_overflow_streak)
        self.rows_written = 0
        self._file = None
        self._csv_writer = None
        self._overflow_incident = 0
        self._in_overflow = False

    # ------------------------------------------------------------- readback
    def _fetch(self, packed: torch.Tensor) -> np.ndarray:
        """THE device-to-host copy. Exactly one call per drained step —
        tests wrap this to count copies."""
        return packed.detach().cpu().numpy()

    def log(self, metrics: Union[Metrics, torch.Tensor], step: int) -> Optional[Row]:
        """Per-step entry point. Off-cadence: returns None without touching
        the device. On-cadence: drains and returns the row."""
        if step % self.every != 0:
            return None
        return self.drain(metrics, step)

    def drain(self, metrics: Union[Metrics, torch.Tensor], step: int) -> Row:
        """Fetch + decode + export one row. Takes the packed vector or the
        metrics dict (packed here first, still one copy). ``Histogram``
        values in a metrics dict are host objects already: they are split
        off before packing and land as ``<name>_p50/_p95/_p99`` columns."""
        histos: Dict[str, Histogram] = {}
        if isinstance(metrics, dict):
            scalars = {}
            for k, v in metrics.items():
                if isinstance(v, Histogram):
                    histos[k] = v
                else:
                    scalars[k] = v
            packed = self.monitor.pack(scalars)
        else:
            packed = metrics
        row = self.monitor.unpack_host(self._fetch(packed))
        row = {"step": int(step), **row}
        for name, h in histos.items():
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                row[f"{name}_{tag}"] = h.quantile(q)
        self._write(row)
        if self.callback is not None:
            self.callback(int(step), row)
        self._check_overflow_streak(row)
        self.rows_written += 1
        return row

    # -------------------------------------------------------------- writers
    def _write(self, row: Row) -> None:
        if self.path is None:
            return
        if self._file is None:
            self._file = open(self.path, "a")
            # crash-flush: rows buffered at every=N survive an uncaught
            # exception (unregistered in close())
            atexit.register(self.flush)
        if self.fmt == "jsonl":
            self._file.write(json.dumps(row) + "\n")
        else:
            if self._csv_writer is None:
                self._csv_writer = csv.DictWriter(
                    self._file, fieldnames=list(row.keys())
                )
                if self._file.tell() == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(row)

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._csv_writer = None
            atexit.unregister(self.flush)

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- warnings
    def _check_overflow_streak(self, row: Row) -> None:
        """One warning per overflow incident (the streak crossing the
        threshold), through ``warn_once``."""
        if self.warn_overflow_streak <= 0:
            return
        streak = row.get("consecutive_overflows", 0)
        if streak >= self.warn_overflow_streak:
            if not self._in_overflow:
                self._in_overflow = True
                self._overflow_incident += 1
            warn_once(
                ("monitor.overflow_streak", id(self), self._overflow_incident),
                "loss-scaler overflow streak: %d consecutive skipped steps at "
                "step %d (loss_scale=%s) — inputs or lr may be unstable",
                int(streak),
                row.get("step"),
                row.get("loss_scale"),
                logger=logger,
            )
        else:
            self._in_overflow = False
