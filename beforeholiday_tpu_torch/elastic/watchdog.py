"""Hang watchdog — counterpart of ``beforeholiday_tpu/elastic/watchdog.py``:
liveness for the failure mode no exception reaches.

A rank that DIES surfaces somewhere: the process reaps with a signal exit,
the collective times out, the run loop sees ``SimulatedPreemption``. A rank
that HANGS — stuck in a driver call, livelocked, NIC half-dead — raises
nothing and exits never; the rest of the job blocks at the next collective
forever. The only defense is a liveness monitor that runs OUTSIDE the data
path: ranks book per-step heartbeats into a host-side ledger, and a daemon
thread flags any rank silent for ``hang_timeout_s``.

Division of labor (host counters only, never a device value):

* :meth:`HangWatchdog.beat` — the per-rank, per-step heartbeat. Host-side
  counters only (a wall-clock stamp and the step number); called between
  steps, never inside the step function.
* the monitor thread (:meth:`_monitor_loop`) — wakes every
  ``poll_interval_s``, scans the ledger, and on a silent rank books a
  ``watchdog`` ledger row and dumps the active flight recorder (the black
  box should capture the hang, not the recovery).
* :meth:`HangWatchdog.check` — the run loop's once-per-step poll (same
  slot as the preemption tick): raises :class:`RankHangError` once a hang
  has been flagged, which ``ElasticTrainer`` treats exactly like a
  guard-tripwire mismatch — drain, drop the silent rank, reshard, replay.

Detection is wall-clock (a hang IS a wall-clock phenomenon) but recovery
stays bitwise: the error only picks WHICH resize happens; the resize path
itself replays from the last durable generation.

Fault injection: :func:`beforeholiday_tpu_torch.testing.faults.hang_rank`
installs a suppressor that swallows one rank's heartbeats — simulating a
silent rank without actually hanging the test loop.

In the port each rank is a process with a watchdog of its own. Every rank
beats for the whole world after a committed step (the step's collectives
completed, so every rank stepped), and a suppressor installed on one
rank's watchdog only silences the beats that rank books. The monitor
threads flag on wall-clock, so ranks may raise at different steps;
``ElasticTrainer`` agrees on the flags over the group before each step, so
every rank acts on a flagged hang at the same step.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from beforeholiday_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "HangWatchdog",
    "RankHangError",
    "reset_watchdog_ledger",
    "watchdog_records",
]

# process-global watchdog ledger: one row per flagged hang, mirroring the
# ckpt ledger's reset/records surface so bench rungs can rollup drills
_LOCK = threading.Lock()
_LEDGER: List[Dict[str, Any]] = []


def reset_watchdog_ledger() -> None:
    """Zero the process-global watchdog ledger (tests/bench rungs)."""
    with _LOCK:
        _LEDGER.clear()


def watchdog_records() -> List[Dict[str, Any]]:
    """Snapshot of flagged hangs: ``{"rank", "last_step", "stalled_for_s",
    "timeout_s"}`` rows in flag order."""
    with _LOCK:
        return [dict(r) for r in _LEDGER]


def _book(row: Dict[str, Any]) -> None:
    with _LOCK:
        _LEDGER.append(row)


class RankHangError(RuntimeError):
    """A rank went silent past the hang timeout.

    Carries the silent ``rank``, how long it had been quiet
    (``stalled_for_s``), and the last step it was heard from
    (``last_step``) — everything a survivor policy needs to pick the
    post-hang world."""

    def __init__(self, message: str, *, rank: int, stalled_for_s: float,
                 last_step: int):
        super().__init__(message)
        self.rank = rank
        self.stalled_for_s = float(stalled_for_s)
        self.last_step = int(last_step)


class HangWatchdog:
    """Heartbeat ledger + monitor thread flagging silent ranks.

    Parameters
    ----------
    world: number of ranks expected to beat.
    hang_timeout_s: silence threshold — a rank unheard for this long is
        flagged as hung.
    poll_interval_s: monitor-thread wake period (default: a quarter of the
        timeout, floored at 10 ms).

    The watchdog tracks SIMULATED ranks on one host exactly like real ones:
    the run loop calls :meth:`beat_all` between steps (every rank that
    stepped is alive by construction), injectors suppress individual ranks'
    beats, and the monitor thread cannot tell the difference. Use as a
    context manager or call :meth:`start`/:meth:`stop`.
    """

    def __init__(self, world: int, *, hang_timeout_s: float = 30.0,
                 poll_interval_s: Optional[float] = None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if hang_timeout_s <= 0:
            raise ValueError(
                f"hang_timeout_s must be > 0, got {hang_timeout_s}"
            )
        self.hang_timeout_s = float(hang_timeout_s)
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else max(0.01, hang_timeout_s / 4.0)
        )
        self._cv = threading.Condition()
        self._suppressors: List[Callable[[int, int], bool]] = []
        self._hung: List[Dict[str, Any]] = []   # flagged, not yet consumed
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._reset_locked_init(world)

    def _reset_locked_init(self, world: int) -> None:
        now = time.monotonic()
        self.world = int(world)
        # the clock starts at reset: a rank that NEVER beats is flagged
        # hang_timeout_s after the watchdog (re)arms, not instantly
        self._last_beat = [now] * world
        self._last_step = [-1] * world

    # ------------------------------------------------------------ heartbeats
    def beat(self, rank: int, step: int) -> bool:
        """Book rank ``rank``'s heartbeat for ``step``; returns False when a
        suppressor swallowed it (the injected hang). Host-side counters
        only — never called inside the step."""
        if not 0 <= rank < self.world:
            raise ValueError(
                f"rank {rank} out of range for world {self.world}"
            )
        with self._cv:
            for suppress in self._suppressors:
                if suppress(rank, step):
                    return False
            self._last_beat[rank] = time.monotonic()
            self._last_step[rank] = int(step)
        return True

    def beat_all(self, step: int) -> int:
        """Heartbeat every rank for ``step`` (the single-process run loop's
        per-step call: every simulated rank that stepped is alive); returns
        how many beats landed (suppressors eat the rest)."""
        return sum(self.beat(r, step) for r in range(self.world))

    def add_suppressor(self, fn: Callable[[int, int], bool]) -> None:
        """Install a ``(rank, step) -> bool`` predicate; a True return
        swallows that heartbeat (fault injection's entry point)."""
        with self._cv:
            self._suppressors.append(fn)

    def remove_suppressor(self, fn: Callable[[int, int], bool]) -> None:
        """Remove a previously installed suppressor ("un-hang" the rank)."""
        with self._cv:
            self._suppressors.remove(fn)

    # -------------------------------------------------------------- monitor
    def start(self) -> "HangWatchdog":
        """Start the monitor thread (daemon; idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = False
        self._thread = threading.Thread(
            target=self._monitor_loop, name="hang-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the monitor thread and join it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _monitor_loop(self) -> None:
        """Daemon scan: flag ranks silent past the timeout, book the
        ``watchdog`` ledger row, dump the flight recorder. Runs entirely on
        host counters — it never touches a device value."""
        while True:
            with self._cv:
                if self._stop:
                    return
                self._scan_locked()
                self._cv.wait(timeout=self.poll_interval_s)

    def _scan_locked(self) -> None:
        now = time.monotonic()
        # a hang is ONE rank silent while its peers advance. When EVERY
        # rank is quiet the coordinator itself is stalled — compiling the
        # step, tracing after a resize, blocked on I/O — and flagging the
        # whole world would turn every recompile into a cascade of resizes;
        # hold fire until someone beats again (world=1 therefore never
        # flags: there is no peer to witness the silence)
        if now - max(self._last_beat) >= self.hang_timeout_s:
            return
        flagged_ranks = {h["rank"] for h in self._hung}
        for rank in range(self.world):
            if rank in flagged_ranks:
                continue
            stalled = now - self._last_beat[rank]
            if stalled < self.hang_timeout_s:
                continue
            row = {
                "rank": rank,
                "last_step": self._last_step[rank],
                "stalled_for_s": float(stalled),
                "timeout_s": self.hang_timeout_s,
            }
            self._hung.append(row)
            _book(row)
            logger.error(
                "watchdog: rank %d silent for %.3fs (timeout %.3fs, last "
                "step %d)", rank, stalled, self.hang_timeout_s,
                self._last_step[rank],
            )
            self._dump_flight(row)

    def _dump_flight(self, row: Dict[str, Any]) -> None:
        from beforeholiday_tpu_torch.monitor.flight import active_flight_recorder

        rec = active_flight_recorder()
        if rec is not None:
            try:
                rec.dump(reason=f"rank_hang:rank{row['rank']}")
            except Exception:  # noqa: BLE001 — the flag must still land
                logger.exception("flight-recorder dump failed in watchdog")

    # -------------------------------------------------------------- polling
    @property
    def hung_ranks(self) -> List[int]:
        """Ranks flagged (and not yet consumed by :meth:`check`)."""
        with self._cv:
            return [h["rank"] for h in self._hung]

    def check(self) -> None:
        """The run loop's once-per-step poll: raise :class:`RankHangError`
        for the oldest unconsumed flag. Consumes ALL pending flags (the
        resize that follows rebuilds the world; stale flags against the old
        world must not re-fire)."""
        with self._cv:
            if not self._hung:
                return
            first, self._hung = self._hung[0], []
        raise RankHangError(
            f"rank {first['rank']} silent for {first['stalled_for_s']:.3f}s "
            f"(hang timeout {self.hang_timeout_s}s, last step "
            f"{first['last_step']})",
            rank=first["rank"],
            stalled_for_s=first["stalled_for_s"],
            last_step=first["last_step"],
        )

    def reset(self, world: Optional[int] = None) -> None:
        """Re-arm for ``world`` ranks (the post-resize call): fresh beat
        clocks, flags cleared, suppressors kept (an injected hang outlives
        a resize only if its predicate still matches)."""
        with self._cv:
            self._reset_locked_init(world if world is not None else self.world)
            self._hung = []
            self._cv.notify_all()

    # ------------------------------------------------------------ persist
    def state_dict(self) -> Dict[str, Any]:
        """Host-side snapshot for the checkpoint manifest's ``extra``:
        last step heard per rank (wall-clock stamps are process-local and
        deliberately NOT persisted)."""
        with self._cv:
            return {
                "world": self.world,
                "last_step": list(self._last_step),
                "hang_timeout_s": self.hang_timeout_s,
            }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore heartbeat steps (clocks re-arm at now — a restore must
        never inherit a pre-crash silence window)."""
        world = int(state["world"])
        steps = [int(s) for s in state["last_step"]]
        if len(steps) != world:
            raise ValueError(
                f"heartbeat state has {len(steps)} ranks, world says {world}"
            )
        with self._cv:
            self._reset_locked_init(world)
            self._last_step = steps
            self._hung = []
