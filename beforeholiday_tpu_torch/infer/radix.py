"""Prefix/radix caching — counterpart of ``beforeholiday_tpu/infer/radix.py``:
shared prompt prefixes map to shared KV pages.

SGLang's observation (Zheng et al., arXiv:2312.07104 — RadixAttention):
production prompt streams are heavily prefix-shared (system prompts,
few-shot preambles, multi-turn histories), so the KV a prefill just wrote is
very often the KV the NEXT request needs. This module is the host half of
that reuse, on the page-table/null-page design of ``infer/kvcache.py``:

* a **radix tree keyed by page-aligned token chunks** — one node per full
  page of tokens, child edges labeled by the page's exact ``page_size``
  token tuple. Only FULL pages enter the tree: a page's KV bytes are a pure
  function of the token prefix through it (causal attention; for e4m3 pages
  the per-page scale comes from the chunk's amax, same argument), so two
  requests agreeing on a full chunk may alias one physical page. Partial
  tails are never shared in place — the matched request re-derives its tail
  on freshly allocated pages (copy-on-write: the engine's ``copy_pages``
  duplicates a full tail page when the whole prompt is cached; shorter
  tails are teacher-forced through decode, which rebuilds the same KV);
* **refcounts as the sharing currency** — the tree holds one allocator ref
  per adopted page, every prefix-matched request adds its own, and a page
  recycles only when the last holder lets go
  (:class:`~beforeholiday_tpu_torch.infer.kvcache.PageAllocator`). Writers
  never touch a shared page: a matched request's first write lands at
  position ``matched_tokens``, which by construction opens a FRESH page;
* **LRU eviction** — on page famine the scheduler evicts least-recently-
  touched leaf nodes (leaves only: an interior node's chunk is a prefix of
  its children's) before resorting to request preemption. Evicting a node
  drops only the TREE's ref; requests still reading the page keep it live.

Everything here is host-side bookkeeping over Python ints and tuples —
no tensor, nothing syncs, and the scheduler drives it strictly between
engine calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from beforeholiday_tpu_torch.infer.kvcache import PageAllocator

__all__ = ["RadixCache"]


class _Node:
    """One full page of cached prefix: ``chunk`` is its page_size-token edge
    label, ``page`` the physical page holding that chunk's KV."""

    __slots__ = ("chunk", "page", "children", "parent", "stamp")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], stamp: int):
        self.chunk = chunk
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = stamp


class RadixCache:
    """Host-side radix tree over page-aligned token prefixes.

    Owns one allocator ref per resident node page. ``lookup`` ALSO takes one
    ref per matched page on the caller's behalf (so a concurrent eviction
    can never recycle a page between match and use); the caller frees the
    refs of any pages it decides not to keep."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size={page_size}")
        self._alloc = allocator
        self._ps = page_size
        self._children: Dict[Tuple[int, ...], _Node] = {}  # root edges
        self._nodes = 0
        self._clock = 0
        # cumulative token-level counters (the serving_report hit rate)
        self.lookup_tokens = 0
        self.hit_tokens = 0

    # ------------------------------------------------------------- accounting

    @property
    def pages_held(self) -> int:
        """Pages the tree currently holds a ref on (== node count)."""
        return self._nodes

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from the tree."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -------------------------------------------------------------- the walk

    def _chunks(self, tokens: Sequence[int]):
        for i in range(0, len(tokens) - self._ps + 1, self._ps):
            yield tuple(tokens[i: i + self._ps])

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest full-page prefix match: returns (pages, matched_tokens),
        with one allocator ref taken per returned page (caller owns them).
        Touches matched nodes' LRU stamps."""
        now = self._tick()
        pages: List[int] = []
        children = self._children
        for chunk in self._chunks(tokens):
            node = children.get(chunk)
            if node is None:
                break
            node.stamp = now
            pages.append(node.page)
            children = node.children
        self._alloc.ref(pages)
        self.lookup_tokens += len(tokens)
        self.hit_tokens += len(pages) * self._ps
        return pages, len(pages) * self._ps

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Adopt the full-page prefix of ``tokens`` into the tree: ``pages``
        is the owner's page list (page i holds tokens ``[i*ps, (i+1)*ps)``).
        Chunks already resident keep their existing page (same bytes by
        construction); new chunks take one tree ref on the owner's page.
        Returns the number of pages newly adopted."""
        now = self._tick()
        adopted = 0
        children = self._children
        parent: Optional[_Node] = None
        for i, chunk in enumerate(self._chunks(tokens)):
            node = children.get(chunk)
            if node is None:
                if i >= len(pages):
                    break  # owner never held this deep
                page = pages[i]
                self._alloc.ref([page])
                node = _Node(chunk, page, parent, now)
                children[chunk] = node
                self._nodes += 1
                adopted += 1
            node.stamp = now
            parent = node
            children = node.children
        return adopted

    # -------------------------------------------------------------- eviction

    def evict(self, n_pages: int = 1) -> int:
        """Release up to ``n_pages`` least-recently-used LEAF nodes' tree
        refs (a page only actually recycles once readers also let go).
        Returns the number of nodes evicted. Called by the scheduler on page
        famine, before it reaches for request preemption."""
        evicted = 0
        while evicted < n_pages:
            victim: Optional[_Node] = None
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif victim is None or node.stamp < victim.stamp:
                    victim = node
            if victim is None:
                break
            siblings = (
                victim.parent.children if victim.parent is not None
                else self._children
            )
            del siblings[victim.chunk]
            self._alloc.free([victim.page])
            self._nodes -= 1
            evicted += 1
        return evicted

    def clear(self) -> int:
        """Drop every node (tests / engine reset); returns nodes released."""
        released = 0
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self._alloc.free([node.page])
            released += 1
        self._children = {}
        self._nodes = 0
        return released
