"""Paged KV cache — counterpart of ``beforeholiday_tpu/infer/kvcache.py``.

The cache is a fixed pool of fixed-size pages per layer; each request owns a
page table mapping its logical slots to physical pages, handed out by the
host-side :class:`PageAllocator`. Page 0 is the reserved null page: padded
table slots point at it, so writes from padding rows land there harmlessly
and reads of padded slots are masked by ``kv_lens`` in the attention kernel.

The k and v pools of all layers are views of one flat zeroed buffer carved by
``ops/arena.py``. The JAX package donates that buffer through every step so
XLA updates it in place (``remat/donation.py``, which has no counterpart
here); PyTorch writes the pools in place with ``index_put_`` instead.

Only fp32 pages are ported. fp8 (``"e4m3"``) pages arrive in a later slice.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from beforeholiday_tpu_torch.ops import arena

__all__ = [
    "KVCache",
    "NULL_PAGE",
    "PageAllocator",
    "PagedLayout",
    "alloc_cache",
    "gather_pages",
    "pages_for",
    "write_prefill",
    "write_token",
]

NULL_PAGE = 0

_PAGE_DTYPES = {"float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged cache."""

    n_layers: int
    n_pages: int  # physical pages per layer, INCLUDING the reserved null page
    page_size: int  # tokens per page
    kv_dim: int  # n_heads * head_dim
    dtype_name: str = "float32"

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages={self.n_pages}: need >= 2 (page 0 is reserved)"
            )
        if self.page_size < 1 or self.kv_dim < 1 or self.n_layers < 1:
            raise ValueError(f"degenerate layout: {self}")
        if self.dtype_name not in _PAGE_DTYPES:
            raise NotImplementedError(
                f"page dtype {self.dtype_name!r} is not ported (float32 only)"
            )

    @property
    def dtype(self) -> torch.dtype:
        return _PAGE_DTYPES[self.dtype_name]

    @property
    def pool_shape(self):
        return (self.n_layers, self.n_pages, self.page_size, self.kv_dim)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class KVCache:
    """The paged pools: ``k``/``v`` shaped ``(n_layers, n_pages, page_size,
    kv_dim)``, both views of the one ``flat`` arena buffer."""

    k: torch.Tensor
    v: torch.Tensor
    layout: PagedLayout
    flat: torch.Tensor


def alloc_cache(layout: PagedLayout, device) -> KVCache:
    """Allocate the k/v page pools out of ONE flat zeroed buffer padded to the
    arena tile."""
    spec = arena.make_spec([layout.pool_shape] * 2)
    flat = torch.zeros((spec.padded_total,), dtype=layout.dtype, device=device)
    k, v = arena.unflatten(flat, spec)
    return KVCache(k, v, layout, flat)


# ---------------------------------------------------------------------------------
# device-side page ops, per layer; each writes ``pages`` in place
# ---------------------------------------------------------------------------------


def write_token(pages: torch.Tensor, page_table: torch.Tensor,
                pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Scatter one new token per sequence into its page, in place.

    ``pages``: (n_pages, page_size, kv_dim) — ONE layer's pool.
    ``page_table``: (B, n_slots) int. ``pos``: (B,) — the logical position
    being written. ``val``: (B, kv_dim). Inactive rows carry an all-null
    table, so their writes land in page 0; duplicate indices there are
    harmless because page 0 is never read unmasked. Values are stored in the
    pool's dtype (a bf16 value widens to fp32 exactly)."""
    ps = pages.shape[1]
    pos = pos.long()
    batch = torch.arange(pos.shape[0], device=pages.device)
    phys = page_table[batch, pos // ps].long()
    return pages.index_put_((phys, pos % ps), val.to(pages.dtype))


def write_prefill(pages: torch.Tensor, page_table: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Bulk-scatter a whole prompt's K or V into its pages, in place.

    ``vals``: (B, S, kv_dim) with ``S % page_size == 0``; chunk ``j`` of row
    ``b`` lands on page ``page_table[b, j]``. Positions past a request's
    length fall on null-page slots or in the tail of its last page, masked by
    ``kv_lens`` until decode overwrites them."""
    B, S, kv = vals.shape
    ps = pages.shape[1]
    if S % ps:
        raise ValueError(
            f"prefill length {S} must be a multiple of page_size {ps}"
        )
    n_slots = S // ps
    phys = page_table[:, :n_slots].reshape(-1).long()
    chunks = vals.to(pages.dtype).reshape(B * n_slots, ps, kv)
    return pages.index_put_((phys,), chunks)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each sequence's logically contiguous K or V view: (n_pages, page_size,
    kv_dim) gathered by (B, n_slots) → (B, n_slots * page_size, kv_dim)."""
    B, n_slots = page_table.shape
    ps, kv = pages.shape[1], pages.shape[2]
    return pages[page_table.long()].reshape(B, n_slots * ps, kv)


# ---------------------------------------------------------------------------------
# host-side page accounting
# ---------------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free list over physical pages ``1 .. n_pages-1`` (page 0
    reserved).

    All-or-nothing allocation: a request is admitted only if its whole ask
    fits. Double frees and foreign pages raise — an accounting bug here would
    silently corrupt another request's cache. :meth:`ref` lets a second holder
    pin a live page; a page returns to the free list when its last holder
    frees it."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need >= 2 (page 0 reserved)")
        self.n_pages = n_pages
        self._free = deque(range(1, n_pages))
        self._refs: Dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently held by at least one owner."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        """Current holders of ``page`` (0 for free pages)."""
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1 each, or None if the pool can't
        cover the whole ask."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Add one reference to each live page; referencing a free page
        raises."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(
                    f"ref on page {p} not currently allocated "
                    f"(stale alias — the page was recycled)"
                )
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page rejoins the free list when its
        count hits zero."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(
                    f"freeing page {p} not currently allocated "
                    f"(double free or foreign page)"
                )
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
