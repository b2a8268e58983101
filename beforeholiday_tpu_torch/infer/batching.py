"""Continuous batching — counterpart of ``beforeholiday_tpu/infer/batching.py``.

Iteration-level scheduling (Orca, Yu et al., OSDI '22) against the page
budget (vLLM): the batch is re-formed at every decode step, a finished
request's pages return to the pool at once, a waiting request joins as soon
as a slot and its pages exist, and when the pool runs dry mid-decode the
YOUNGEST active request is preempted by recompute (its pages are freed and it
re-prefills later over prompt + generated; greedy decoding makes the replay
token-identical).

Everything here is host-side bookkeeping between engine calls. The prefix
cache (``prefix_cache=True``, ``infer/radix.py``) and the telemetry hooks
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from beforeholiday_tpu_torch.infer.engine import InferenceEngine
from beforeholiday_tpu_torch.infer.kvcache import PageAllocator, pages_for

__all__ = ["ContinuousBatcher", "Request", "static_batched_generate"]


@dataclasses.dataclass
class Request:
    """One generation request plus its scheduling state."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0  # open-loop arrival time (now_fn timebase)
    out: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0  # tokens whose KV is resident
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens

    @property
    def sequence(self) -> List[int]:
        """Prompt plus everything generated — what a (re-)prefill runs on."""
        return self.prompt + self.out


class ContinuousBatcher:
    """Decode-step-granularity scheduler over one :class:`InferenceEngine`.

    ``step()`` is one iteration: admit what fits (one bucketed prefill for
    the newcomers), then one bucketed decode for every active request, then
    retire the finished."""

    def __init__(self, engine: InferenceEngine, *,
                 now_fn: Callable[[], float] = time.perf_counter,
                 prefix_cache: bool = False):
        if prefix_cache:
            raise NotImplementedError("the radix prefix cache is not ported yet")
        self.engine = engine
        self.allocator = PageAllocator(engine.cfg.num_pages)
        self.waiting: deque = deque()
        self.active: List[Request] = []
        self.finished: List[Request] = []
        self._now = now_fn
        self._ps = engine.cfg.page_size
        # worst-case resident length: prompt + all-but-the-last generated
        # token (the final token is sampled, never cached)
        self._max_resident = min(
            engine.cfg.max_seq_len, engine.cfg.prefill_seq_buckets[-1]
        )

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens < 1")
        resident = len(req.prompt) + req.max_new_tokens - 1
        if resident > self._max_resident:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens needs {resident} resident "
                f"slots > {self._max_resident} (max_seq_len / largest "
                f"prefill bucket)"
            )
        if pages_for(resident, self._ps) > self.allocator.n_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs more pages than the whole pool"
            )
        self.waiting.append(req)

    # ------------------------------------------------------------- scheduling

    def _collect(self, now: float, room: int, prefill_cap: int) -> List[Request]:
        """Pull arrived FIFO work that fits (pages allocated), at most
        ``min(room, prefill_cap)`` requests."""
        batch: List[Request] = []
        while self.waiting and len(batch) < min(room, prefill_cap):
            req = self.waiting[0]
            if req.arrival > now:
                break  # open-loop: not yet arrived (FIFO — no reordering)
            pages = self.allocator.alloc(pages_for(len(req.sequence), self._ps))
            if pages is None:
                break  # page famine: stop admitting, decode will free some
            req.pages = pages
            batch.append(self.waiting.popleft())
        return batch

    def _run_prefill(self, batch: List[Request]) -> None:
        first = self.engine.prefill(
            [r.sequence for r in batch], [r.pages for r in batch]
        )
        t = self._now()
        for r, tok in zip(batch, first.tolist()):
            r.cached = len(r.sequence)
            r.out.append(tok)
            if r.first_token_time is None:
                r.first_token_time = t

    def _admit(self, now: float) -> None:
        batch = self._collect(
            now, self.engine.cfg.max_batch - len(self.active),
            self.engine.cfg.max_prefill_batch,
        )
        if batch:
            self._run_prefill(batch)
            self.active.extend(batch)

    def _preempt(self, victim: Request) -> None:
        self.active.remove(victim)
        self.allocator.free(victim.pages)
        victim.pages = []
        victim.cached = 0
        victim.preemptions += 1
        self.waiting.appendleft(victim)

    def _ensure_pages(self) -> None:
        """Every active request whose next write crosses a page boundary gets
        a fresh page; famine preempts LIFO (youngest admitted first)."""
        for r in list(self.active):
            while r in self.active and r.cached >= len(r.pages) * self._ps:
                got = self.allocator.alloc(1)
                if got is not None:
                    r.pages.extend(got)
                    break
                self._preempt(self.active[-1])

    def _decode(self) -> None:
        """One decode tick: every active row feeds ``sequence[cached]`` (its
        last sampled token) at position ``cached``."""
        if not self.active:
            return
        nxt = self.engine.decode(
            [r.sequence[r.cached] for r in self.active],
            [r.cached for r in self.active],
            [r.pages for r in self.active],
        )
        t = self._now()
        for r, tok in zip(self.active, nxt.tolist()):
            r.cached += 1
            if r.cached >= len(r.prompt):
                r.out.append(tok)
                if r.first_token_time is None:
                    r.first_token_time = t

    def step(self) -> List[Request]:
        """One scheduler iteration; returns the requests retired by it."""
        self._admit(self._now())
        self._retire()  # a 1-token request is done straight out of prefill
        self._ensure_pages()
        self._decode()
        return self._retire()

    def _retire(self) -> List[Request]:
        done = [r for r in self.active if r.done]
        if not done:
            return []
        t = self._now()
        for r in done:
            r.finish_time = t
            self.allocator.free(r.pages)
            r.pages = []
        self.active = [r for r in self.active if not r.done]
        self.finished.extend(done)
        return done

    def run(self, *, max_steps: Optional[int] = None) -> List[Request]:
        """Drive until idle. ``max_steps`` is a runaway backstop."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"batcher not idle after {max_steps} steps "
                    f"({len(self.waiting)} waiting, {len(self.active)} active)"
                )
        return self.finished


def static_batched_generate(
    engine: InferenceEngine,
    requests: Sequence[Request],
    *,
    now_fn: Callable[[], float] = time.perf_counter,
) -> List[Request]:
    """Request-level (static) batching baseline at the same page budget:
    batches form in arrival order, every member reserves its worst-case page
    ask up front, and the batch's slots stay occupied until its longest
    member finishes."""
    allocator = PageAllocator(engine.cfg.num_pages)
    queue = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
    finished: List[Request] = []
    while queue:
        now = now_fn()
        if queue[0].arrival > now:
            continue  # spin until the next arrival (open-loop fidelity)
        batch: List[Request] = []
        while queue and len(batch) < engine.cfg.max_batch:
            r = queue[0]
            if r.arrival > now:
                break
            pages = allocator.alloc(
                pages_for(len(r.prompt) + r.max_new_tokens - 1,
                          engine.cfg.page_size)
            )
            if pages is None:
                break
            r.pages = pages
            batch.append(queue.popleft())
        if not batch:
            continue
        first = engine.prefill(
            [r.prompt for r in batch], [r.pages for r in batch]
        )
        t = now_fn()
        for r, tok in zip(batch, first.tolist()):
            r.cached = len(r.prompt)
            r.out.append(tok)
            r.first_token_time = t
            if r.done:
                r.finish_time = t
        while True:
            live = [r for r in batch if not r.done]
            if not live:
                break
            nxt = engine.decode(
                [r.out[-1] for r in live],
                [r.cached for r in live],
                [r.pages for r in live],
            )
            t = now_fn()
            for r, tok in zip(live, nxt.tolist()):
                r.cached += 1
                r.out.append(tok)
                if r.done:
                    r.finish_time = t
        for r in batch:
            allocator.free(r.pages)
            r.pages = []
        finished.extend(batch)
    return finished
