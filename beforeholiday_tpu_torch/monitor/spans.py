"""Trace spans, profiler traces and timers — counterpart of
``beforeholiday_tpu/monitor/spans.py`` (the former ``utils/timers.py`` and
``utils/profiling.py``, both kept as re-export shims).

Ref: apex/transformer/pipeline_parallel/_timers.py:83 ``_Timers`` and the
NVTX ranges gated by ``prof`` in DDP (apex/parallel/distributed.py:360-361).

* ``span`` / ``annotate`` — a ``torch.profiler.record_function`` range (it
  shows in a ``torch.profiler`` trace, with the device kernels it launched
  under it) plus an NVTX range on a CUDA build (it shows in Nsight). When a
  ``monitor.timeline`` recorder is active the span also lands on the host
  timeline (a ``B``/``E`` pair), as JAX's does. None of it reads a device
  value, so the DDP reducer carries spans unconditionally.
* ``trace`` / ``start_trace`` / ``stop_trace`` — a ``torch.profiler`` trace
  of the CPU and, with a card, the CUDA activity, written into ``log_dir``
  as a Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler and
  Perfetto read).
* ``Timers`` — named wall-clock timers. On the card a timer records a CUDA
  event at ``start`` and at ``stop`` on the current stream and reads their
  distance when asked (``elapsed`` waits for the last event, a sanctioned
  sync between steps); it times the device's work between the two points.
  On the CPU it reads ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "Timers",
    "annotate",
    "nvtx_range",
    "span",
    "start_trace",
    "stop_trace",
    "trace",
]


@contextlib.contextmanager
def span(name: str, enabled: bool = True):
    """Named trace span: a profiler range, an NVTX range where CUDA is built
    in, and a host-timeline span while a ``timeline`` recorder is active.
    ``enabled=False`` makes it a no-op (the reference's ``prof`` flag)."""
    if not enabled:
        yield
        return
    from beforeholiday_tpu_torch.monitor.trace import active_recorder

    rec = active_recorder()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with contextlib.ExitStack() as stack:
            if rec is not None:
                stack.enter_context(rec.span(name))
            stack.enter_context(torch.profiler.record_function(name))
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# the JAX package's older name for the same thing
nvtx_range = span


def annotate(name: str):
    """Decorator: run the function inside :func:`span` ``(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


_PROFILER: List[torch.profiler.profile] = []


def start_trace(log_dir: str, **kw) -> None:
    """Begin a ``torch.profiler`` trace, written into ``log_dir`` at
    :func:`stop_trace`. ``kw`` goes to ``torch.profiler.profile``."""
    if _PROFILER:
        raise RuntimeError("a profiler trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kw.setdefault("activities", acts)
    prof = torch.profiler.profile(
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir), **kw)
    prof.start()
    _PROFILER.append(prof)


def stop_trace() -> None:
    """End the trace :func:`start_trace` began and write it."""
    if not _PROFILER:
        raise RuntimeError("no profiler trace is running")
    _PROFILER.pop().stop()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the enclosed block when ``log_dir`` is set; no-op otherwise —
    so trainers can take a ``--profile-dir`` flag and leave the call in."""
    if log_dir:
        start_trace(log_dir)
        try:
            yield
        finally:
            stop_trace()
    else:
        yield


class _Timer:
    def __init__(self, name: str, device: torch.device):
        self.name = name
        self._cuda = device.type == "cuda"
        self._device = device
        self._elapsed = 0.0
        self._started = False
        self._start_time = 0.0
        self._start_event = None
        # (start, end) event pairs recorded and not yet read
        self._pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def start(self, barrier_on=None):
        """``barrier_on`` is accepted for parity: an event on the stream
        already follows the work issued before it."""
        assert not self._started, f"timer {self.name} already started"
        if self._cuda:
            self._start_event = self._event()
        else:
            self._start_time = time.perf_counter()
        self._started = True

    def stop(self, barrier_on=None):
        assert self._started, f"timer {self.name} not started"
        if self._cuda:
            self._pending.append((self._start_event, self._event()))
        else:
            self._elapsed += time.perf_counter() - self._start_time
        self._started = False

    def reset(self):
        self._elapsed = 0.0
        self._pending.clear()
        self._started = False

    def elapsed(self, reset: bool = True) -> float:
        """Seconds timed so far (waits for the last event on the card)."""
        running = self._started
        if running:
            self.stop()
        for a, b in self._pending:
            b.synchronize()
            self._elapsed += a.elapsed_time(b) / 1e3
        self._pending.clear()
        value = self._elapsed
        if reset:
            self.reset()
        if running:
            self.start()
        return value


class Timers:
    """Group of named timers (ref: _timers.py:120 ``Timers``), on the card
    unless ``device`` asks for the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name, self.device)
        return self._timers[name]

    def log(self, names, normalizer: float = 1.0, reset: bool = True) -> str:
        for name in names:
            # a typo'd timer name must be loud, not silently dropped
            assert name in self._timers, f"timer {name!r} was never started"
        parts = [
            f"{name}: {self._timers[name].elapsed(reset=reset) * 1000.0 / normalizer:.2f}ms"
            for name in names
        ]
        return "time (ms) | " + " | ".join(parts)
