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

**fp8 pages** (``dtype_name="e4m3"``) store saturating e4m3 values under one
fp32 scale per (layer, page), in ``(n_layers, n_pages)`` planes beside the
arena (which is single-dtype). A page's scale is fixed at its first write
(prefill: from the page chunk's amax with headroom ``margin``; decode: from
the token that opens the page) and later tokens saturate at it. The gather
dequantizes (:func:`gather_pages_quantized`, fp32 out), and the error model
is :func:`kv_dequant_error_bound` (per element) and
:func:`kv_logit_error_bound` (the end-to-end envelope), on the e4m3 error
model of ``ops.quantized``. Page bytes move through
their ``uint8`` view in the index ops, so every copy, gather and scatter is
a byte move. As in JAX, duplicate scatter indices arise only on the null
page (padding rows and padded slots), whose content and scale are never
read: live pages are written deterministically.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from beforeholiday_tpu_torch.ops import arena
from beforeholiday_tpu_torch.ops.quantized import E4M3_MAX, E4M3_REL, E4M3_TINY, div

__all__ = [
    "KVCache",
    "NULL_PAGE",
    "PageAllocator",
    "PagedLayout",
    "alloc_cache",
    "gather_pages",
    "gather_pages_quantized",
    "kv_dequant_error_bound",
    "kv_logit_error_bound",
    "pages_for",
    "write_prefill",
    "write_prefill_quantized",
    "write_token",
    "write_token_quantized",
]

NULL_PAGE = 0

_PAGE_DTYPES = {"float32": torch.float32}
# quantized page formats: dtype_name -> storage dtype; their scales ride in
# (n_layers, n_pages) fp32 planes
_KV_QUANT_DTYPES = {"e4m3": torch.float8_e4m3fn}

# first-write scale headroom: amax maps to E4M3_MAX / margin, so tokens
# written later under the frozen scale have 2x room before they saturate
# (the default margin of ``ops.quantized.scales_from_history``)
KV_SCALE_MARGIN = 2.0


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
        if self.dtype_name not in {**_PAGE_DTYPES, **_KV_QUANT_DTYPES}:
            raise NotImplementedError(
                f"page dtype {self.dtype_name!r} is not ported (float32 and "
                f"e4m3 only)"
            )

    @property
    def quantized(self) -> bool:
        """True when pages store an fp8 format under per-page scales."""
        return self.dtype_name in _KV_QUANT_DTYPES

    @property
    def dtype(self) -> torch.dtype:
        return {**_PAGE_DTYPES, **_KV_QUANT_DTYPES}[self.dtype_name]

    @property
    def pool_shape(self):
        return (self.n_layers, self.n_pages, self.page_size, self.kv_dim)

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def tokens_per_layer(self) -> int:
        return self.usable_pages * self.page_size

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page across k and v and all layers, scales
        included: the capacity unit the fp8 ratio divides."""
        per = self.page_size * self.kv_dim * self.dtype.itemsize
        scale = 4 if self.quantized else 0  # one fp32 scale per (layer, page)
        return self.n_layers * 2 * (per + scale)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class KVCache:
    """The paged pools: ``k``/``v`` shaped ``(n_layers, n_pages, page_size,
    kv_dim)``, both views of the one ``flat`` arena buffer. Quantized
    layouts add the ``k_scale``/``v_scale`` planes, ``(n_layers, n_pages)``
    fp32 (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    layout: PagedLayout
    flat: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def reset(self) -> None:
        """Zeroed pools and unit scales, in place."""
        self.flat.view(torch.uint8).zero_()
        for s in (self.k_scale, self.v_scale):
            if s is not None:
                s.fill_(1.0)


def alloc_cache(layout: PagedLayout, device) -> KVCache:
    """Allocate the k/v page pools out of ONE flat zeroed buffer padded to the
    arena tile. Quantized layouts add the scale planes, at 1.0: under it the
    zeroed null page dequantizes to exactly 0."""
    spec = arena.make_spec([layout.pool_shape] * 2)
    flat = torch.zeros((spec.padded_total,), dtype=layout.dtype, device=device)
    k, v = arena.unflatten(flat, spec)
    if not layout.quantized:
        return KVCache(k, v, layout, flat)
    planes = [torch.ones((layout.n_layers, layout.n_pages), dtype=torch.float32,
                         device=device) for _ in range(2)]
    return KVCache(k, v, layout, flat, *planes)


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


# -- fp8 (e4m3) page variants -----------------------------------------------------


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor's uint8 view (other dtypes as they are): index ops move
    its bytes."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _page_scale(amax: torch.Tensor, margin: float) -> torch.Tensor:
    """amax -> the e4m3 scale with headroom; 1.0 for an all-zero chunk (under
    which zeros round-trip to exactly 0: the null-page invariant)."""
    return torch.where(amax > 0.0, div(E4M3_MAX / margin, amax), 1.0)


def _q_pages(vals: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    # SATURATING, the forward-operand contract of ops/quantized.py: a frozen
    # page scale clips a late outlier, never inf or NaN
    t = vals.to(torch.float32) * scale
    return t.clamp_(-E4M3_MAX, E4M3_MAX).to(dtype)


def write_token_quantized(pages: torch.Tensor, scales: torch.Tensor,
                          page_table: torch.Tensor, pos: torch.Tensor,
                          val: torch.Tensor, *, margin: float = KV_SCALE_MARGIN
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`write_token` for e4m3 pages, in place: one token a sequence
    quantized under its page's scale, the scale set from the token's own
    amax when the write OPENS the page (``pos % page_size == 0``); later
    tokens on the page saturate at the frozen scale. ``scales``: (n_pages,)
    fp32, this layer's plane. Returns (pages, scales)."""
    ps = pages.shape[1]
    pos = pos.long()
    batch = torch.arange(pos.shape[0], device=pages.device)
    phys = page_table[batch, pos // ps].long()
    off = pos % ps
    amax = val.to(torch.float32).abs().amax(dim=-1)
    # a row mid-page keeps its page's scale (rewriting the same value); rows
    # collide only on the null page, whose scale is never read
    row_scale = torch.where(off == 0, _page_scale(amax, margin), scales[phys])
    scales.index_put_((phys,), row_scale)
    q = _q_pages(val, row_scale[:, None], pages.dtype)
    _bytes(pages).index_put_((phys, off), _bytes(q))
    return pages, scales


def write_prefill_quantized(pages: torch.Tensor, scales: torch.Tensor,
                            page_table: torch.Tensor, vals: torch.Tensor, *,
                            margin: float = KV_SCALE_MARGIN
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`write_prefill` for e4m3 pages, in place: one scale a page from
    that page's own chunk amax. Attention is causal, so a page's chunk, and
    with it its scale and bytes, is a function of the token prefix through
    that page. Returns (pages, scales)."""
    B, S, kv = vals.shape
    ps = pages.shape[1]
    if S % ps:
        raise ValueError(
            f"prefill length {S} must be a multiple of page_size {ps}"
        )
    n_slots = S // ps
    phys = page_table[:, :n_slots].reshape(-1).long()
    chunks = vals.to(torch.float32).reshape(B * n_slots, ps, kv)
    scale = _page_scale(chunks.abs().amax(dim=(1, 2)), margin)
    scales.index_put_((phys,), scale)
    q = _q_pages(chunks, scale[:, None, None], pages.dtype)
    _bytes(pages).index_put_((phys,), _bytes(q))
    return pages, scales


def gather_pages_quantized(pages: torch.Tensor, scales: torch.Tensor,
                           page_table: torch.Tensor) -> torch.Tensor:
    """:func:`gather_pages` with the dequantization: the pages and their
    scales gathered by the same table, each page times its scale's
    reciprocal, fp32 out. The null page holds zeros, which dequantize to 0
    under any scale."""
    B, n_slots = page_table.shape
    ps, kv = pages.shape[1], pages.shape[2]
    idx = page_table.long()
    q = _bytes(pages)[idx].view(pages.dtype).to(torch.float32)
    deq = q * (1.0 / scales[idx])[:, :, None, None]
    return deq.reshape(B, n_slots * ps, kv)


# -- analytic error bounds ---------------------------------------------------------


def kv_dequant_error_bound(values, scales) -> torch.Tensor:
    """Per-element bound on ``|dequant(quant(v)) - v|`` for e4m3 pages under
    ``scales`` (broadcastable against ``values``): the round-to-nearest
    ``E4M3_REL·|v|``, the subnormal floor ``E4M3_TINY / s`` and the
    saturation excess ``max(0, |v| - E4M3_MAX / s)`` a frozen scale
    charges a late outlier."""
    v = torch.as_tensor(values, dtype=torch.float32).abs()
    s = torch.as_tensor(scales, dtype=torch.float32, device=v.device)
    clip = torch.clamp(v - div(E4M3_MAX, s), min=0.0)
    return E4M3_REL * v + div(E4M3_TINY, s) + clip


def kv_logit_error_bound(step, *, n_layers: int, logit_ceiling: float,
                         margin: float = KV_SCALE_MARGIN,
                         growth: float = 1.5) -> float:
    """The envelope of ``max|logits_e4m3(t) - logits_fp32(t)|`` at decode
    step ``t``: ``logit_ceiling · ((1 + 4·eps)**n_layers - 1) ·
    growth**step`` with ``eps = E4M3_REL + margin · E4M3_TINY / E4M3_MAX``,
    the worst relative dequant error of an element whose page scale was set
    at first write with ``margin``; the factor 4 covers the key side's
    softmax sensitivity and the residual path, layers compound, the fp32
    run's largest |logit| turns relative into absolute, and ``growth``
    majorizes the step-to-step accumulation. Worst case over everything,
    hence loose."""
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    eps = E4M3_REL + margin * E4M3_TINY / E4M3_MAX
    compounded = (1.0 + 4.0 * eps) ** n_layers - 1.0
    return float(logit_ceiling) * compounded * float(growth) ** float(step)


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
