"""Request-level serving telemetry — counterpart of
``beforeholiday_tpu/infer/telemetry.py``: lifecycle records, latency
histograms, Perfetto tracks, and SLO burn-rate gates.

The continuous batcher owns every timestamp that matters; this module is the
passive observer it calls at each lifecycle transition (enqueue → admit →
first token → decode tick → {preempt, finish}). Everything here is host-side
bookkeeping on those calls:

* **per-request records** (:class:`RequestRecord`) — the raw material for a
  post-hoc audit and the payload attached to an SLO-breach flight dump;
* **latency histograms** — TTFT, inter-token gap, and e2e land in mergeable
  log-spaced :class:`~beforeholiday_tpu_torch.monitor.histo.Histogram`\\ s,
  so ``serving_report()`` p50/p95/p99 carry the analytic
  ``quantile_error_bound`` instead of a raw-list sort;
* **Perfetto tracks** — when a ``monitor.timeline()`` recorder is active,
  each request gets its own process row (``pid`` = rid) holding a
  ``req:queued`` / ``req:active`` span chain (re-queued on preemption) plus
  a ``first_token`` instant, and the scheduler books counter tracks
  (``pages_free``, ``batch_fill``, ``queue_depth``) every step. With no
  recorder active every span call is a no-op;
* **SLO burn rate** (:class:`SLOPolicy`) — declared latency targets judged
  with the multi-window burn-rate rule: breach only when the error budget
  burns faster than ``burn_threshold`` over BOTH the short and the long
  window. A breach fires the active
  :class:`~beforeholiday_tpu_torch.monitor.flight.FlightRecorder` dump once
  per target, with the offending request records attached.

No method here touches a device value or calls a clock: the batcher hands
in host floats and ints it already read back at the step boundary, on its
own clock, so fake-clock runs are deterministic.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from beforeholiday_tpu_torch.monitor.histo import Histogram
from beforeholiday_tpu_torch.monitor.trace import active_recorder

__all__ = ["RequestRecord", "SLOPolicy", "ServingTelemetry"]


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps for one request (scheduler ``now_fn`` timebase,
    seconds). ``admit``/``first_token`` keep the FIRST occurrence; preempted
    requests re-admit without rewriting them (``replays`` counts the extra
    prefills)."""

    rid: int
    prompt_tokens: int
    max_new_tokens: int
    enqueue: float
    admit: Optional[float] = None
    first_token: Optional[float] = None
    last_token: Optional[float] = None
    finish: Optional[float] = None
    tokens: int = 0
    prefill_s: float = 0.0
    preemptions: int = 0
    replays: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.enqueue

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.enqueue

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ttft_s"] = self.ttft_s
        d["e2e_s"] = self.e2e_s
        return d


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Declared latency targets plus the multi-window burn-rate rule.

    A request "errors" against a target when its measured latency exceeds
    it. With objective ``q`` (fraction of requests that must meet the
    target), the sustainable error rate is ``1 - q``; the burn rate of a
    window is ``(observed error fraction) / (1 - q)``. A target breaches
    when burn > ``burn_threshold`` over BOTH ``short_window_s`` and
    ``long_window_s`` — the standard two-window guard: the long window
    proves budget is really burning, the short window proves it is burning
    NOW (so the alarm clears quickly once the fault stops)."""

    ttft_ms: Optional[float] = None
    e2e_ms: Optional[float] = None
    objective: float = 0.99
    short_window_s: float = 5.0
    long_window_s: float = 60.0
    burn_threshold: float = 2.0
    min_events: int = 8  # don't judge a window on fewer samples

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1): {self.objective}")
        if self.short_window_s > self.long_window_s:
            raise ValueError("short_window_s must be <= long_window_s")

    def targets(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.ttft_ms is not None:
            out["ttft_ms"] = self.ttft_ms
        if self.e2e_ms is not None:
            out["e2e_ms"] = self.e2e_ms
        return out


def _window_burn(
    events: Deque[Tuple[float, bool]], now: float, window_s: float,
    objective: float, min_events: int,
) -> Optional[float]:
    lo = now - window_s
    n = bad = 0
    for ts, ok in events:
        if ts >= lo:
            n += 1
            if not ok:
                bad += 1
    if n < min_events:
        return None
    return (bad / n) / (1.0 - objective)


class ServingTelemetry:
    """Passive per-request observer the :class:`ContinuousBatcher` drives.

    Construct with optional histogram geometry knobs and an
    :class:`SLOPolicy`; pass to the batcher. All hooks take the scheduler's
    own clock readings — the telemetry never calls a clock, so fake-clock
    tests are fully deterministic.
    """

    def __init__(self, *, slo: Optional[SLOPolicy] = None,
                 histo_lo: float = 1e-5, histo_decades: int = 8,
                 histo_bins_per_decade: int = 20,
                 trace_requests: bool = True):
        geometry = dict(lo=histo_lo, decades=histo_decades,
                        bins_per_decade=histo_bins_per_decade)
        self.ttft = Histogram(**geometry)
        self.itl = Histogram(**geometry)
        self.e2e = Histogram(**geometry)
        self.slo = slo
        self.records: Dict[int, RequestRecord] = {}
        self._trace_requests = trace_requests
        self._open_span: Dict[int, str] = {}  # rid -> open span name
        self._first_enqueue: Optional[float] = None
        self._last_event: Optional[float] = None
        self._tokens_total = 0
        self._tokens_delivered = 0
        self._finished = 0
        self._preemptions = 0
        self._replays = 0
        self._steps = 0
        # prefix-cache (radix) reuse counters — token- and request-level
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._prefix_lookup_tokens = 0
        self._prefix_hit_tokens = 0
        # SLO state: per-target (ts, ok) event streams + breach latches
        self._slo_events: Dict[str, Deque[Tuple[float, bool]]] = {}
        self._slo_offenders: Dict[str, List[Dict[str, Any]]] = {}
        self._breached: Dict[str, bool] = {}
        if slo is not None:
            for key in slo.targets():
                self._slo_events[key] = deque()
                self._slo_offenders[key] = []
                self._breached[key] = False

    # ------------------------------------------------------- trace plumbing

    def _span_switch(self, rid: int, name: Optional[str]) -> None:
        """Close the request's open span and (optionally) open ``name`` —
        keeps each request's track a flat, perfectly nested B/E chain."""
        if not self._trace_requests:
            return
        rec = active_recorder()
        if rec is None:
            return
        if self._open_span.pop(rid, None) is not None:
            rec.end(rank=rid)
        if name is not None:
            rec.begin(name, rank=rid)
            self._open_span[rid] = name

    def _instant(self, rid: int, name: str) -> None:
        if not self._trace_requests:
            return
        rec = active_recorder()
        if rec is not None:
            rec.instant(name, rank=rid)

    # ------------------------------------------------------------ lifecycle

    def on_enqueue(self, req: Any, now: float) -> None:
        enqueue = req.arrival if req.arrival > 0.0 else now
        self.records[req.rid] = RequestRecord(
            rid=req.rid, prompt_tokens=len(req.prompt),
            max_new_tokens=req.max_new_tokens, enqueue=enqueue,
        )
        if self._first_enqueue is None or enqueue < self._first_enqueue:
            self._first_enqueue = enqueue
        self._touch(now)
        self._span_switch(req.rid, "req:queued")

    def on_admit(self, batch: List[Any], now: float,
                 prefill_s: float) -> None:
        """After one bucketed prefill admitted ``batch`` (each member just
        got its first token of this admission)."""
        share = prefill_s / len(batch) if batch else 0.0
        for r in batch:
            rec = self.records.get(r.rid)
            if rec is None:
                continue
            rec.prefill_s += share
            rec.tokens += 1
            self._tokens_total += 1
            if rec.admit is None:
                rec.admit = now
            else:
                rec.replays += 1
                self._replays += 1
            self._span_switch(r.rid, "req:active")
            if rec.first_token is None and r.first_token_time is not None:
                rec.first_token = r.first_token_time
                ttft = rec.first_token - rec.enqueue
                self.ttft.update(max(ttft, 0.0))
                self._observe_slo("ttft_ms", ttft * 1e3, rec, now)
                self._instant(r.rid, "first_token")  # rides req:active
            rec.last_token = now
        self._touch(now)

    def on_prefix_lookup(self, hit_tokens: int, prompt_tokens: int,
                         now: float) -> None:
        """One radix-cache probe at admission: ``hit_tokens`` of the
        ``prompt_tokens``-token prompt were served from shared pages
        (0 on a miss)."""
        self._prefix_lookups += 1
        self._prefix_lookup_tokens += prompt_tokens
        if hit_tokens > 0:
            self._prefix_hits += 1
            self._prefix_hit_tokens += hit_tokens
        self._touch(now)

    def on_prefix_admit(self, batch: List[Any], now: float) -> None:
        """Prefix-hit requests entering decode-extend: admitted with NO
        prefill and no token yet — the first real token (and TTFT) lands on
        a later decode tick."""
        for r in batch:
            rec = self.records.get(r.rid)
            if rec is None:
                continue
            if rec.admit is None:
                rec.admit = now
            self._span_switch(r.rid, "req:active")
        self._touch(now)

    def on_preempt(self, req: Any, now: float) -> None:
        rec = self.records.get(req.rid)
        if rec is not None:
            rec.preemptions += 1
        self._preemptions += 1
        self._touch(now)
        self._span_switch(req.rid, "req:queued")

    def on_decode_tick(self, active: List[Any], now: float) -> None:
        for r in active:
            rec = self.records.get(r.rid)
            if rec is None:
                continue
            rec.tokens += 1
            self._tokens_total += 1
            if rec.last_token is not None:
                gap = now - rec.last_token
                if gap > 0.0:
                    self.itl.update(gap)
            rec.last_token = now
            if rec.first_token is None and getattr(
                r, "first_token_time", None
            ) is not None:
                # decode-extend requests earn their first token on a decode
                # tick, not at admission
                rec.first_token = r.first_token_time
                ttft = rec.first_token - rec.enqueue
                self.ttft.update(max(ttft, 0.0))
                self._observe_slo("ttft_ms", ttft * 1e3, rec, now)
                self._instant(r.rid, "first_token")
        self._touch(now)

    def on_retire(self, done: List[Any], now: float) -> None:
        for r in done:
            rec = self.records.get(r.rid)
            if rec is None:
                continue
            rec.finish = now
            self._finished += 1
            self._tokens_delivered += len(r.out)
            e2e = now - rec.enqueue
            self.e2e.update(max(e2e, 0.0))
            self._observe_slo("e2e_ms", e2e * 1e3, rec, now)
            self._span_switch(r.rid, None)
        self._touch(now)
        self._check_slo(now)

    def on_step(self, now: float, *, free_pages: int, active: int,
                waiting: int, max_batch: int) -> None:
        """Once per scheduler iteration: gauge samples + SLO window check."""
        self._steps += 1
        self._touch(now)
        rec = active_recorder()
        if rec is not None:
            rec.counter("pages_free", free_pages)
            rec.counter("batch_fill", active / max_batch if max_batch else 0.0)
            rec.counter("queue_depth", waiting)
        self._check_slo(now)

    def _touch(self, now: float) -> None:
        if self._last_event is None or now > self._last_event:
            self._last_event = now

    # ------------------------------------------------------------------ SLO

    def _observe_slo(self, key: str, value_ms: float, rec: RequestRecord,
                     now: float) -> None:
        events = self._slo_events.get(key)
        if events is None:
            return
        target = self.slo.targets()[key]
        ok = value_ms <= target
        events.append((now, ok))
        if not ok:
            offenders = self._slo_offenders[key]
            offenders.append({**rec.as_dict(), f"observed_{key}": value_ms})
            del offenders[:-64]  # keep the most recent offenders only
        # retire events older than the long window (plus slack for clock skew)
        horizon = now - 2.0 * self.slo.long_window_s
        while events and events[0][0] < horizon:
            events.popleft()

    def _check_slo(self, now: float) -> None:
        if self.slo is None:
            return
        from beforeholiday_tpu_torch.monitor.flight import active_flight_recorder

        for key, target in self.slo.targets().items():
            if self._breached[key]:
                continue  # latched: one dump per target per run
            events = self._slo_events[key]
            short = _window_burn(events, now, self.slo.short_window_s,
                                 self.slo.objective, self.slo.min_events)
            long_ = _window_burn(events, now, self.slo.long_window_s,
                                 self.slo.objective, self.slo.min_events)
            if (short is not None and long_ is not None
                    and short > self.slo.burn_threshold
                    and long_ > self.slo.burn_threshold):
                self._breached[key] = True
                fr = active_flight_recorder()
                if fr is not None:
                    fr.record(self._steps, {
                        f"slo_burn_short_{key}": short,
                        f"slo_burn_long_{key}": long_,
                        f"slo_target_{key}": target,
                    }, extra={"requests": list(self._slo_offenders[key])})
                    fr.dump(reason=f"slo_breach:{key}")

    @property
    def breached(self) -> Dict[str, bool]:
        return dict(self._breached)

    # --------------------------------------------------------------- report

    def histograms(self) -> Dict[str, Histogram]:
        """The latency histograms by name (``ttft_s``, ``itl_s``,
        ``e2e_s``)."""
        return {"ttft_s": self.ttft, "itl_s": self.itl, "e2e_s": self.e2e}

    def serving_report(self) -> Dict[str, Any]:
        """Roll-up: throughput, goodput, per-histogram p50/p95/p99 (ms),
        scheduler churn, SLO state."""
        if self._first_enqueue is not None and self._last_event is not None:
            wall = max(self._last_event - self._first_enqueue, 0.0)
        else:
            wall = 0.0
        out: Dict[str, Any] = {
            "requests": len(self.records),
            "finished": self._finished,
            "steps": self._steps,
            "wall_s": wall,
            "tokens": self._tokens_total,
            "tokens_delivered": self._tokens_delivered,
            "tokens_per_s": self._tokens_total / wall if wall else 0.0,
            "goodput_tokens_per_s": (
                self._tokens_delivered / wall if wall else 0.0
            ),
            "preemptions": self._preemptions,
            "prefill_replays": self._replays,
            "prefix_lookups": self._prefix_lookups,
            "prefix_hits": self._prefix_hits,
            "prefix_hit_rate": (
                self._prefix_hit_tokens / self._prefix_lookup_tokens
                if self._prefix_lookup_tokens else 0.0
            ),
            "prefix_hit_tokens": self._prefix_hit_tokens,
            "quantile_error_bound": self.ttft.quantile_error_bound,
        }
        for name, h in (("ttft", self.ttft), ("itl", self.itl),
                        ("e2e", self.e2e)):
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                out[f"{name}_{tag}_ms"] = h.quantile(q) * 1e3
        if self.slo is not None:
            out["slo_targets"] = self.slo.targets()
            out["slo_breached"] = dict(self._breached)
        return out
