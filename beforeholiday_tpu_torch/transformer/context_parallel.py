"""Context parallelism: ring attention over the ``context`` group —
counterpart of ``beforeholiday_tpu/transformer/context_parallel.py``.

Each rank of the context group holds a contiguous slice of the sequence, in
rank order. At ring step t rank r holds the K/V chunk that started on rank
``(r - t) mod cp`` and folds it into its queries' attention; the chunks
move one hop a step over ``monitor.comms``' ppermute (site
``cp.ring_attention.kv``), whose backward sends the gradient K/V back the
opposite way, as JAX's transpose of ``ppermute`` does (booked at
``cp.ring_attention.kv.bwd``). Causality is decided per global position.

Two paths, chosen by shape as in JAX: on the kernel path (the card) with
``is_flash_available(S_local, D)`` every hop is one
:func:`~beforeholiday_tpu_torch.ops.attention.flash_attention_with_lse`
call (K2 forward, K4 with the ``dlse`` term backward): hop 0 the rank's own
chunk, causal; every later hop a chunk wholly before the rank's (all keys,
``kv_lens`` S_local) or wholly after it (``kv_lens`` 0), and the hops merge
by their log-sum-exps (:func:`_merge_by_lse`). Otherwise each hop updates
fp32 online-softmax accumulators (:func:`_online_hop`). :func:`_hop` and
:func:`_merge_by_lse` are module functions, so one device can compose a
ring rank by rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.attention import (
    flash_attention_with_lse,
    is_flash_available,
)
from beforeholiday_tpu_torch.parallel.parallel_state import CONTEXT_AXIS, get_group

__all__ = ["ring_attention"]

_NEG = -1e30
SITE = "cp.ring_attention.kv"


def _hop(q3, k3, v3, *, causal_hop: bool, kv_len: int, scale: float,
         impl: Optional[str] = None):
    """One flash hop: ``(o fp32, lse)`` of ``q3`` against one K/V chunk,
    ``(BH, S_local, D)`` each. ``causal_hop``: the rank's own chunk;
    otherwise ``kv_len`` keys of the chunk attend (S_local for a chunk
    before the rank's, 0 for one after it)."""
    if causal_hop:
        o, lse = flash_attention_with_lse(q3, k3, v3, causal=True, scale=scale,
                                          impl=impl)
    else:
        lens = torch.full((q3.shape[0],), kv_len, dtype=torch.int32,
                          device=q3.device)
        o, lse = flash_attention_with_lse(q3, k3, v3, causal=False, scale=scale,
                                          kv_lens=lens, impl=impl)
    return o.float(), lse


def _merge_by_lse(o_a, lse_a, o_b, lse_b):
    """Two normalized chunk outputs combined by their log-sum-exps, the
    blockwise flash-attention merge. An empty chunk carries lse = -1e30,
    whose weight underflows to exactly zero."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    o = (o_a * wa[..., None] + o_b * wb[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _online_hop(qf, k_cur, v_cur, src, rank, causal, scale, m, l, acc):
    """Fold the K/V chunk that started on rank ``src`` into the fp32
    online-softmax accumulators ``(m, l, acc)`` of this rank's queries."""
    Sl = qf.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * scale
    if causal:
        pos = torch.arange(Sl, device=qf.device)
        masked = (src * Sl + pos)[None, :] > (rank * Sl + pos)[:, None]
        s = s.masked_fill(masked, _NEG)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    if causal:
        p = p.masked_fill(masked, 0.0)
    l = alpha * l + p.sum(-1, keepdim=True)
    acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
    return m_new, l, acc


def _ring(axis_name):
    group = get_group(axis_name)
    cp, rank = dist.get_world_size(group), dist.get_rank(group)
    return cp, rank, [(i, (i + 1) % cp) for i in range(cp)]


def _shift(t, axis_name, perm):
    return comms.ppermute_differentiable(t, axis_name, perm, site=SITE)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    axis_name: str = CONTEXT_AXIS,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Sequence-sharded attention over the group ``axis_name`` names.
    q, k, v: this rank's ``(B, H, S_local, D)`` slice of a sequence laid
    out in rank order. Returns ``(B, H, S_local, D)`` in q's dtype.
    Differentiable in q, k and v.

    ``impl`` (None: by device) ``"kernel"`` runs the flash hops on K2/K4
    where ``is_flash_available(S_local, D)``, else the fp32 online-softmax
    hops; ``"torch"`` runs the online-softmax hops."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S_local, D), got {tuple(q.shape)}")
    B, H, Sl, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if (resolve_impl(impl, q, op="ring_attention") == "kernel"
            and is_flash_available(Sl, D)):
        return _ring_attention_flash(q, k, v, causal=causal, scale=scale,
                                     axis_name=axis_name, impl="kernel")
    cp, rank, perm = _ring(axis_name)
    qf = q.float()
    m = torch.full((B, H, Sl, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=q.device)
    # chunk 0 is local; then cp - 1 rotate-then-compute steps, no dead hop
    m, l, acc = _online_hop(qf, k, v, rank, rank, causal, scale, m, l, acc)
    k_cur, v_cur = k, v
    for t in range(1, cp):
        k_cur, v_cur = _shift(k_cur, axis_name, perm), _shift(v_cur, axis_name, perm)
        m, l, acc = _online_hop(qf, k_cur, v_cur, (rank - t) % cp, rank, causal,
                                scale, m, l, acc)
    nonempty = l > 0.0
    out = torch.where(nonempty, acc / torch.where(nonempty, l, 1.0), 0.0)
    return out.to(q.dtype)


def _ring_attention_flash(q, k, v, *, causal, scale, axis_name, impl=None):
    """The flash hops (see the module docstring); ``impl`` is the hops'
    (K2/K4, or their plain versions)."""
    cp, rank, perm = _ring(axis_name)
    B, H, Sl, D = q.shape
    q3 = q.reshape(B * H, Sl, D)

    def chunk(t):
        return t.reshape(B * H, Sl, D)

    o_acc, lse_acc = _hop(q3, chunk(k), chunk(v), causal_hop=causal, kv_len=Sl,
                          scale=scale, impl=impl)
    k_cur, v_cur = k, v
    for t in range(1, cp):
        k_cur, v_cur = _shift(k_cur, axis_name, perm), _shift(v_cur, axis_name, perm)
        src = (rank - t) % cp
        o_t, lse_t = _hop(q3, chunk(k_cur), chunk(v_cur), causal_hop=False,
                          kv_len=Sl if not causal or src < rank else 0,
                          scale=scale, impl=impl)
        o_acc, lse_acc = _merge_by_lse(o_acc, lse_acc, o_t, lse_t)
    out = torch.where((lse_acc > _NEG / 2)[..., None], o_acc, 0.0)
    return out.reshape(B, H, Sl, D).to(q.dtype)
