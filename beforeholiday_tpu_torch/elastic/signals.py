"""Real preemption bridge — counterpart of
``beforeholiday_tpu/elastic/signals.py``: OS signals routed into the
elastic run loop.

The drills inject :class:`~beforeholiday_tpu_torch.testing.faults.
SimulatedPreemption` from a host-side tick; a REAL preemption arrives as a
signal (a cloud preemption notice is a SIGTERM to the worker; operators use
SIGUSR1 for a manual drain). A signal handler cannot safely touch CUDA,
threads, or files mid-step — so the bridge is two halves joined by one
plain int:

* :class:`PreemptionNotice` installs a handler for its signals that does
  nothing but record the signum in a host-side flag (async-signal-safe:
  one attribute store);
* :meth:`PreemptionNotice.tick` — called by ``ElasticTrainer.run()`` once
  per step, OUTSIDE the step function, exactly where the
  ``preempt_after`` injector ticks — consumes the flag and raises the
  SAME :class:`SimulatedPreemption` the simulated path raises, so the
  trainer's resize/drain machinery needs no second code path. The poll
  reads a Python int; the trainer then agrees on the notice over the
  group, so every rank drains or resizes at the same step.

Composition with :meth:`monitor.FlightRecorder.arm_preemption_dump` (which
dumps the black box and then re-delivers the signal so the process dies a
truthful signal death): when a notice is installed for the same signal, the
contract flips to **dump first, then graceful drain** —

* recorder armed LAST: its handler owns the signal; after dumping it finds
  the notice registered as a graceful consumer
  (:func:`monitor.flight.register_preemption_consumer`) and hands the
  notice off instead of re-delivering;
* notice installed LAST: its handler owns the signal; it asks the active
  flight recorder to dump before setting the flag.

Either order: exactly one dump, the flag set, no signal re-delivery — the
run loop drains (checkpoint made durable) and the process exits 0 with the
black box on disk.
"""

from __future__ import annotations

import signal as _signal
from typing import Optional, Sequence, Tuple

from beforeholiday_tpu_torch.testing.faults import SimulatedPreemption
from beforeholiday_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["PreemptionNotice"]

DEFAULT_SIGNALS = (_signal.SIGTERM, _signal.SIGUSR1)


def _signame(signum: int) -> str:
    try:
        return _signal.Signals(signum).name
    except ValueError:  # pragma: no cover — exotic signum
        return str(signum)


class PreemptionNotice:
    """Host-side flag set by a signal, polled by the elastic run loop.

    Parameters
    ----------
    signums: signals that mean "you are being preempted" (default SIGTERM +
        SIGUSR1).
    surviving_world: world size to resize to when the notice fires (rides
        the raised ``SimulatedPreemption``); ``None`` defers to the
        trainer (``drain`` decides whether that means policy-shrink or
        graceful drain).
    drain: ``True`` (the default when no ``surviving_world`` is named)
        marks the notice as "this process is going away" — the trainer
        checkpoints, drains, and returns cleanly instead of resizing in
        place.

    Use as a context manager or call :meth:`install`/:meth:`uninstall`;
    install is main-thread-only (``signal.signal``'s contract).
    """

    def __init__(
        self,
        signums: Sequence[int] = DEFAULT_SIGNALS,
        *,
        surviving_world: Optional[int] = None,
        drain: Optional[bool] = None,
    ):
        if not signums:
            raise ValueError("PreemptionNotice needs at least one signal")
        self.signums: Tuple[int, ...] = tuple(int(s) for s in signums)
        self.surviving_world = surviving_world
        self.drain = bool(
            drain if drain is not None else surviving_world is None
        )
        self._prev: dict = {}
        self._installed = False
        # the one word of shared state: 0 = quiet, else the signum seen.
        # a plain int store is async-signal-safe and the run loop only ever
        # reads it between steps — no lock needed, no host sync added
        self._flag = 0

    # ----------------------------------------------------------- installing
    def install(self) -> "PreemptionNotice":
        """Install the handler for every configured signal and register as
        the graceful-drain consumer with the flight recorder's preemption
        machinery. Idempotent."""
        if self._installed:
            return self
        from beforeholiday_tpu_torch.monitor import flight

        for s in self.signums:
            self._prev[s] = _signal.signal(s, self._handler)
            flight.register_preemption_consumer(s, self._notify)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previous dispositions and unregister the consumer
        (only where this notice is still the registered one). No-op when
        not installed."""
        if not self._installed:
            return
        from beforeholiday_tpu_torch.monitor import flight

        for s, prev in self._prev.items():
            flight.unregister_preemption_consumer(s, self._notify)
            # only restore if our handler is still installed — an armed
            # flight recorder that displaced us is left alone
            if _signal.getsignal(s) == self._handler:
                _signal.signal(
                    s, prev if prev is not None else _signal.SIG_DFL
                )
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionNotice":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -------------------------------------------------------------- handler
    def _handler(self, signum, frame) -> None:
        """The installed signal handler: dump the active flight recorder
        (dump-first contract), then record the notice. Nothing else — no
        CUDA, no locks beyond the recorder's own."""
        from beforeholiday_tpu_torch.monitor.flight import active_flight_recorder

        rec = active_flight_recorder()
        if rec is not None:
            try:
                rec.dump(reason=f"preemption:{_signame(signum)}")
            except Exception:  # noqa: BLE001 — never mask the notice
                logger.exception(
                    "flight-recorder dump failed in preemption notice"
                )
        self._notify(signum)

    def _notify(self, signum: int) -> None:
        """Record the notice (also the entry point the flight recorder's
        own handler calls after ITS dump, when it owns the signal)."""
        self._flag = int(signum)

    # -------------------------------------------------------------- polling
    @property
    def triggered(self) -> bool:
        """True once a configured signal has been seen (until consumed)."""
        return self._flag != 0

    def tick(self) -> None:
        """The once-per-step poll: when the flag is set, consume it and
        raise :class:`SimulatedPreemption` carrying this notice's
        ``surviving_world``/``drain`` — the bridge into the trainer's
        existing resize/drain path. Plugs into the same
        ``ElasticTrainer.run(..., preemption=...)`` slot as
        ``faults.preempt_after``."""
        signum, self._flag = self._flag, 0
        if signum:
            raise SimulatedPreemption(
                f"preemption notice ({_signame(signum)})",
                surviving_world=self.surviving_world,
                drain=self.drain,
            )
