"""Continuous batching — counterpart of ``beforeholiday_tpu/infer/batching.py``.

Iteration-level scheduling (Orca, Yu et al., OSDI '22) against the page
budget (vLLM): the batch is re-formed at every decode step, a finished
request's pages return to the pool at once, a waiting request joins as soon
as a slot and its pages exist, and when the pool runs dry mid-decode the
YOUNGEST active request is preempted by recompute (its pages are freed and it
re-prefills later over prompt + generated; greedy decoding makes the replay
token-identical).

With ``prefix_cache=True`` admitted prompts' full pages enter a radix tree
(``infer/radix.py``): a later prompt sharing a full-page prefix aliases those
pages and skips prefill past the match, its unmatched tail teacher-forced
through decode ("decode-extend"), and page famine evicts the tree's least
recently used leaves before it preempts a request. A ``telemetry`` observer
(``infer/telemetry.py``) receives every lifecycle transition on this
scheduler's clock.

Everything here is host-side bookkeeping between engine calls — Python
ints, lists, ``deque``s. The only device work is the engine calls, whose
shapes are bucket-padded inside the engine; ``step()`` reads back one token
per active request per iteration.

``static_batched_generate`` is the paired baseline: same engine, same page
budget, same buckets, but a batch admits only when the previous one fully
drains, and holds worst-case pages for every member up front.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence

from beforeholiday_tpu_torch.infer.engine import InferenceEngine
from beforeholiday_tpu_torch.infer.kvcache import PageAllocator, pages_for
from beforeholiday_tpu_torch.infer.radix import RadixCache

__all__ = ["ContinuousBatcher", "Request", "static_batched_generate"]


@dataclasses.dataclass
class Request:
    """One generation request plus its scheduling state."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0  # open-loop arrival time (now_fn timebase)
    # progress (owned by the scheduler)
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

    ``step()`` is one scheduler iteration: admit what fits (one bucketed
    prefill for the newcomers), then one bucketed decode for every active
    request, then retire the finished. Drive it from a loop or the async
    open-loop driver in ``beforeholiday_tpu_torch/examples/serve``.
    """

    def __init__(self, engine: InferenceEngine, *,
                 now_fn: Callable[[], float] = time.perf_counter,
                 telemetry: Optional[Any] = None,
                 prefix_cache: bool = False):
        self.engine = engine
        self.allocator = PageAllocator(engine.cfg.num_pages)
        self.waiting: deque = deque()
        self.active: List[Request] = []
        self.finished: List[Request] = []
        self._now = now_fn
        # passive lifecycle observer (infer/telemetry.ServingTelemetry); every
        # hook receives this scheduler's own clock readings
        self.telemetry = telemetry
        self._ps = engine.cfg.page_size
        # prefix/radix caching (infer/radix.py): admitted prompts' full pages
        # enter a host-side radix tree; later prompts sharing a full-page
        # prefix alias those pages read-only and skip prefill past the match
        # (the unmatched tail is teacher-forced through the decode entry
        # point — "decode-extend" — so the declared signature set stays
        # closed). Default OFF.
        self.radix = (
            RadixCache(self.allocator, self._ps) if prefix_cache else None
        )
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
        if self.telemetry is not None:
            self.telemetry.on_enqueue(req, self._now())

    # ------------------------------------------------------------- scheduling

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate with prefix-cache pressure relief: on famine, evict LRU
        tree-only pages (a cheaper casualty than preempting a live request —
        evicted prefixes re-prefill on the NEXT miss, preempted requests
        replay unconditionally) and retry."""
        got = self.allocator.alloc(n)
        while got is None and self.radix is not None:
            if not self.radix.evict(1):
                break
            got = self.allocator.alloc(n)
        return got

    def _try_extend(self, req: Request, now: float) -> bool:
        """Prefix-cache admission: alias the matched full pages and enter
        decode-extend (teacher-force the unmatched prompt tail, one token per
        decode tick, batched with everyone else's decodes). When the WHOLE
        prompt is cached, the tail page is copy-on-write duplicated instead
        (``engine.copy_pages``) so only the last prompt token re-runs.
        Returns False (nothing held) when there's no usable match or the
        fresh-page ask can't be met."""
        hit, m = self.radix.lookup(req.prompt)
        if self.telemetry is not None and hasattr(
            self.telemetry, "on_prefix_lookup"
        ):
            self.telemetry.on_prefix_lookup(
                min(m, len(req.prompt)), len(req.prompt), now
            )
        if not hit:
            return False
        n_prompt = len(req.prompt)
        copy_src = None
        if m >= n_prompt:
            # fully cached: the last page becomes the COW copy source — the
            # final prompt token must re-run for its logits, and its KV write
            # may only land on a page this request owns
            copy_src = hit[-1]
            hit = hit[:-1]
        total = pages_for(len(req.sequence), self._ps)
        fresh = self._alloc_pages(total - len(hit))
        if fresh is None:
            self.allocator.free(hit + ([copy_src] if copy_src else []))
            return False
        req.pages = hit + fresh
        if copy_src is not None:
            self.engine.copy_pages([copy_src], [fresh[0]])
            self.allocator.free([copy_src])  # drop the lookup ref on the src
            req.cached = n_prompt - 1
        else:
            req.cached = len(hit) * self._ps
        return True

    def _collect(self, now: float, room: int,
                 prefill_cap: int) -> "tuple[List[Request], List[Request]]":
        """Pull arrived FIFO work that fits: returns (batch, extended) —
        newcomers needing a full prefill (≤ ``prefill_cap``, pages
        allocated) and prefix hits already holding their aliased+fresh pages
        (``room`` bounds the sum — the decode regime's capacity)."""
        batch: List[Request] = []
        extended: List[Request] = []
        while self.waiting and len(batch) + len(extended) < room:
            req = self.waiting[0]
            if req.arrival > now:
                break  # open-loop: not yet arrived (FIFO — no reordering)
            if (self.radix is not None and not req.out
                    and self._try_extend(req, now)):
                extended.append(self.waiting.popleft())
                continue
            if len(batch) >= prefill_cap:
                break  # this prefill is full; FIFO holds the rest
            pages = self._alloc_pages(pages_for(len(req.sequence), self._ps))
            if pages is None:
                break  # page famine: stop admitting, decode will free some
            req.pages = pages
            batch.append(self.waiting.popleft())
        return batch, extended

    def _run_prefill(self, batch: List[Request]) -> None:
        """One bucketed prefill over ``batch`` + all bookkeeping (first
        tokens, telemetry, radix adoption of the freshly-written prompt
        pages)."""
        t0 = self._now()
        first = self.engine.prefill(
            [r.sequence for r in batch], [r.pages for r in batch]
        )
        t = self._now()
        for r, tok in zip(batch, first.tolist()):
            r.cached = len(r.sequence)
            r.out.append(tok)
            if r.first_token_time is None:
                r.first_token_time = t
        if self.telemetry is not None:
            self.telemetry.on_admit(batch, t, t - t0)
        if self.radix is not None:
            # adopt the freshly-written full prompt pages right away — the
            # very next admission can hit them
            for r in batch:
                self.radix.insert(r.prompt, r.pages)

    def _admit(self, now: float) -> None:
        batch, extended = self._collect(
            now, self.engine.cfg.max_batch - len(self.active),
            self.engine.cfg.max_prefill_batch,
        )
        if extended:
            self.active.extend(extended)
            if self.telemetry is not None and hasattr(
                self.telemetry, "on_prefix_admit"
            ):
                self.telemetry.on_prefix_admit(extended, self._now())
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
        if self.telemetry is not None:
            self.telemetry.on_preempt(victim, self._now())

    def _ensure_pages(self) -> None:
        """Every active request whose next write crosses a page boundary gets
        a fresh page; famine preempts LIFO (youngest admitted first) — the
        preempted request replays later from prompt+generated."""
        for r in list(self.active):
            while r in self.active and r.cached >= len(r.pages) * self._ps:
                got = self._alloc_pages(1)
                if got is not None:
                    r.pages.extend(got)
                    break
                self._preempt(self.active[-1])

    def _decode(self) -> None:
        """One decode tick. Every active row feeds ``sequence[cached]`` at
        position ``cached`` — for a steady-state request that IS its last
        sampled token (``out[-1]``); for a decode-extend request it is the
        next teacher-forced prompt token, whose predicted output is discarded
        until the prompt is exhausted (the prediction for position
        ``len(prompt)-1`` is the request's real first token)."""
        if not self.active:
            return
        nxt = self.engine.decode(
            [r.sequence[r.cached] for r in self.active],
            [r.cached for r in self.active],
            [r.pages for r in self.active],
        )
        t = self._now()
        emitted: List[Request] = []
        for r, tok in zip(self.active, nxt.tolist()):
            r.cached += 1
            if r.cached >= len(r.prompt):
                r.out.append(tok)
                if r.first_token_time is None:
                    r.first_token_time = t
                emitted.append(r)
        if self.telemetry is not None and emitted:
            self.telemetry.on_decode_tick(emitted, t)

    def step(self) -> List[Request]:
        """One scheduler iteration; returns the requests retired by it."""
        now = self._now()
        self._admit(now)
        self._retire()  # a 1-token request is done straight out of prefill
        self._ensure_pages()
        self._decode()
        done = self._retire()
        if self.telemetry is not None:
            self.telemetry.on_step(
                self._now(), free_pages=self.allocator.available,
                active=len(self.active), waiting=len(self.waiting),
                max_batch=self.engine.cfg.max_batch,
            )
        return done

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
        if self.telemetry is not None:
            self.telemetry.on_retire(done, t)
        return done

    def run(self, *, max_steps: Optional[int] = None) -> List[Request]:
        """Drive until idle (tests / closed-loop use; the async driver calls
        ``step()`` itself). ``max_steps`` is a runaway backstop."""
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
    """Request-level (static) batching baseline, at the same page budget.

    Batches form in arrival order; every member reserves its WORST-CASE page
    ask up front (prompt + max_new resident tokens) and the whole batch's
    slots stay occupied until the longest member finishes — the two wastes
    continuous batching removes. Decode steps run only the unfinished rows
    (bucket padding absorbs the rest), which flatters the baseline slightly;
    the gap between the two is therefore the SCHEDULING win alone."""
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
