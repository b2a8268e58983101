"""Prefill/decode disaggregation — counterpart of
``beforeholiday_tpu/infer/disagg.py``: two regimes, two bucket sets.

DistServe/Splitwise's observation: prefill and decode are DIFFERENT
workloads sharing one model. Prefill is compute-bound (one request's S
tokens amortize every weight load), decode is bandwidth-bound (one token per
request per step re-streams the weights and the KV pages). Batching them
interchangeably forces one bucket geometry onto both: decode capacity gets
capped by the prefill batch dimension, and a large prefill stalls every
decoder tick behind it.

This module splits the two regimes WITHOUT splitting the model or the
cache:

* the engine declares **separate bucket sets** for prefill and decode
  (``EngineConfig.decode_batch_buckets``): prefill buckets stay small —
  sized for an arrival burst — while decode buckets track the full resident
  batch. Both are gated up front, so the signature set stays closed
  (``track_compiles(strict=True)``), disaggregation included;
* the KV handoff is a **page-table transfer, not a copy**: both regimes
  address one pool (``infer/kvcache.py``), so a prefilled request's pages
  are already where decode will read them. The ``handoff`` queue carries
  host-side ints only;
* the scheduler runs **decode-priority**: every ``step()`` decodes the
  active set FIRST, then runs at most one small-bucket prefill for newly
  arrived work, with backpressure (prefill admits only what the decode
  regime has room to absorb).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, List, Optional

from beforeholiday_tpu_torch.infer.batching import ContinuousBatcher, Request
from beforeholiday_tpu_torch.infer.engine import InferenceEngine

__all__ = ["DisaggregatedBatcher"]


class DisaggregatedBatcher(ContinuousBatcher):
    """Decode-priority scheduler with a prefill→decode handoff queue.

    Requires an engine whose :class:`EngineConfig` declares
    ``decode_batch_buckets`` wider than (or equal to) ``batch_buckets`` —
    prefill runs at the small buckets, decode at the large ones. With the
    two bucket sets equal this degrades gracefully to continuous batching
    with a one-step admission delay.
    """

    def __init__(self, engine: InferenceEngine, *,
                 now_fn: Callable[[], float] = time.perf_counter,
                 telemetry: Optional[Any] = None,
                 prefix_cache: bool = False):
        super().__init__(engine, now_fn=now_fn, telemetry=telemetry,
                         prefix_cache=prefix_cache)
        # prefilled (or prefix-extended) requests waiting to join the decode
        # regime — their KV pages are already resident, so joining is a
        # host-side list append (the page-table handoff)
        self.handoff: deque = deque()

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active and not self.handoff

    # ------------------------------------------------------------- scheduling

    def _join(self) -> None:
        """Move handed-off requests into the decode active set while decode
        capacity lasts (the zero-copy handoff: pages stay put, only the
        page-table ints change hands)."""
        room = self.engine.cfg.max_batch - len(self.active)
        while self.handoff and room > 0:
            self.active.append(self.handoff.popleft())
            room -= 1

    def _prefill_tick(self, now: float) -> None:
        """At most one small-bucket prefill over newly arrived work, with
        backpressure: admit only what the decode regime can absorb."""
        room = (self.engine.cfg.max_batch
                - len(self.active) - len(self.handoff))
        batch, extended = self._collect(
            now, room, self.engine.cfg.max_prefill_batch
        )
        if extended:
            self.handoff.extend(extended)
            if self.telemetry is not None and hasattr(
                self.telemetry, "on_prefix_admit"
            ):
                self.telemetry.on_prefix_admit(extended, self._now())
        if batch:
            self._run_prefill(batch)
            self.handoff.extend(batch)

    def _preempt(self, victim: Request) -> None:
        # LIFO famine relief must be able to claw back handed-off requests
        # too — they hold pages but aren't in ``active`` yet
        if victim in self.handoff:
            self.handoff.remove(victim)
            self.allocator.free(victim.pages)
            victim.pages = []
            victim.cached = 0
            victim.preemptions += 1
            self.waiting.appendleft(victim)
            if self.telemetry is not None:
                self.telemetry.on_preempt(victim, self._now())
            return
        super()._preempt(victim)

    def _ensure_pages(self) -> None:
        """Same boundary-crossing top-up as the parent, but famine preempts
        the handoff queue first (youngest investment, nothing decoded yet),
        then falls back to the youngest active request."""
        for r in list(self.active):
            while r in self.active and r.cached >= len(r.pages) * self._ps:
                got = self._alloc_pages(1)
                if got is not None:
                    r.pages.extend(got)
                    break
                self._preempt(
                    self.handoff[-1] if self.handoff else self.active[-1]
                )

    def step(self) -> List[Request]:
        """One scheduler iteration, decode-priority:

        join handoff → top up pages → decode → retire → prefill tick →
        join again (this step's prefills reach decode next tick at the
        latest) → retire (1-token requests finish straight out of prefill).
        """
        now = self._now()
        self._join()
        self._retire()  # handed-off 1-token requests are already done
        self._ensure_pages()
        self._decode()
        done = self._retire()
        self._prefill_tick(now)
        self._join()
        done += self._retire()
        if self.telemetry is not None:
            self.telemetry.on_step(
                self._now(), free_pages=self.allocator.available,
                active=len(self.active), waiting=len(self.waiting),
                max_batch=self.engine.cfg.max_batch,
            )
        return done
