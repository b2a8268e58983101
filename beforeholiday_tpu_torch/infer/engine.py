"""Inference engine — bucketed prefill/decode over one resident paged cache.

Counterpart of ``beforeholiday_tpu/infer/engine.py``. The bucket contract is
the same: :class:`EngineConfig` declares the finite set of batch sizes and
prefill lengths, every call is padded up to the smallest bucket that fits
(padding rides the null page and ``kv_lens`` masking), and each entry point
is held to its declared number of signatures by
``monitor.track_compiles(strict=True)``, which raises
:class:`~beforeholiday_tpu_torch.monitor.BucketGateError` on an undeclared
shape. PyTorch runs eagerly, so no executable is compiled per signature; the
gate still catches a bucket table and a scheduler that disagree, and keeps
:attr:`InferenceEngine.compiled_signatures` meaningful.

The forward mirrors ``testing/gpt.py`` (a Python loop over layers), re-derived
for incremental decode. LayerNorm runs on kernel K1 and attention on kernel
K2 when the engine lives on the card; ``impl="torch"`` selects their plain
versions (the CPU path, and the card-side yardstick). Decode on the kernels
reads each layer's fp32 page pools in place through the page table (K2's
paged mode, ``ops.attention._paged_decode_kernel``) at the head dims K2's
decode path is built for (``DECODE_HEAD_DIMS``); at other head dims, and on
the plain path, it gathers the pages, narrows them to the compute dtype and
runs the contiguous attention (K2's row kernel, or its plain version), the
same function as the JAX engine's gather followed by ``flash_attention``.
On fp8 pages (``EngineConfig(cache_dtype="e4m3")``) prefill writes each
page under its own scale and attends to the exact k and v, and decode
writes the fed token under its page's scale, gathers and dequantizes the
pages to fp32 and runs the contiguous attention in fp32 (q widened,
exactly; K2's decode path on the kernels), as the JAX engine attends to
the dequantized fp32 copy; the context is then rounded to the compute
dtype. K2's paged mode reads fp32 pools only. The page pools are updated
in place. The JAX engine's timeline span is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.infer import kvcache
from beforeholiday_tpu_torch.monitor.compile import track_compiles
from beforeholiday_tpu_torch.ops import flash_attention, fused_dense, fused_layer_norm
from beforeholiday_tpu_torch.ops._autocast import cast_floats
from beforeholiday_tpu_torch.ops._dispatch import IMPLS, resolve_device
from beforeholiday_tpu_torch.ops.attention import (
    DECODE_HEAD_DIMS,
    _decode_contiguous,
    _decode_gathered,
    _paged_decode_kernel,
    _paged_decode_torch,
    flash_fwd_kernel,
    flash_fwd_torch,
)

__all__ = ["EngineConfig", "InferenceEngine", "pick_bucket"]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static serving geometry — buckets, pages, dtypes.

    ``batch_buckets`` / ``prefill_seq_buckets`` define the CLOSED signature
    set: decode has one signature per batch bucket, prefill one per (batch
    bucket, seq bucket) pair. Prefill buckets must be page-aligned and fit
    ``max_seq_len``."""

    max_seq_len: int = 128
    page_size: int = 16
    num_pages: int = 65  # physical pages per layer, incl. the null page
    batch_buckets: Tuple[int, ...] = (4, 8)
    prefill_seq_buckets: Tuple[int, ...] = (32, 64, 128)
    # decode-side batch buckets; None shares ``batch_buckets``
    decode_batch_buckets: Optional[Tuple[int, ...]] = None
    # one-time weight cast at construction (e.g. "bfloat16"); None keeps the
    # checkpoint dtype. compute dtype follows the weights unless forced.
    weights_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    # "float32" (default) or "e4m3": fp8 pages under per-(layer, page)
    # scales, see infer/kvcache.py's quantized variants
    cache_dtype: str = "float32"
    strict_buckets: bool = True
    entry_prefix: str = "infer"

    def __post_init__(self):
        if self.max_seq_len % self.page_size:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} must be a multiple of "
                f"page_size {self.page_size}"
            )
        for name in ("batch_buckets", "decode_batch_buckets",
                     "prefill_seq_buckets"):
            b = getattr(self, name)
            if b is not None and tuple(sorted(b)) != tuple(b):
                raise ValueError(f"{name} must ascend: {b}")
        for s in self.prefill_seq_buckets:
            if s % self.page_size:
                raise ValueError(
                    f"prefill bucket {s} not page-aligned "
                    f"(page_size {self.page_size})"
                )
            if s > self.max_seq_len:
                raise ValueError(
                    f"prefill bucket {s} exceeds max_seq_len {self.max_seq_len}"
                )

    @property
    def n_slots(self) -> int:
        """Page-table width: logical slots per request."""
        return self.max_seq_len // self.page_size

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        return self.decode_batch_buckets or self.batch_buckets

    @property
    def max_batch(self) -> int:
        """Active-set capacity — how many requests decode can carry."""
        return self.decode_buckets[-1]

    @property
    def max_prefill_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def declared_prefill_signatures(self) -> int:
        return len(self.batch_buckets) * len(self.prefill_seq_buckets)

    @property
    def declared_decode_signatures(self) -> int:
        return len(self.decode_buckets)

    @property
    def declared_copy_signatures(self) -> int:
        """The whole-page copy pads to ``max_batch``: one signature."""
        return 1

    @property
    def declared_signatures(self) -> int:
        return (
            self.declared_prefill_signatures
            + self.declared_decode_signatures
            + self.declared_copy_signatures
        )


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest declared bucket >= n; out of range raises."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest declared bucket {buckets[-1]}")


class InferenceEngine:
    """Bucketed prefill/decode over one resident paged cache.

    * ``prefill(prompts, page_tables) -> next_tokens`` runs full prompts,
      fills their pages and returns the first generated token per request;
    * ``decode(tokens, lens, page_tables) -> next_tokens`` writes each fed
      token's K/V at position ``len`` and samples greedily.

    ``params`` is this package's GPT parameter dict (``testing/gpt.py``);
    it is moved to ``device`` (``cuda`` unless the caller asks for another),
    cast once to ``cfg.weights_dtype``. ``impl`` selects the kernels
    (``"kernel"``, the default on the card) or their plain versions
    (``"torch"``) for LayerNorm and attention."""

    def __init__(self, params: Dict[str, Any], model_cfg: Any,
                 cfg: EngineConfig, *, device=None,
                 impl: Optional[str] = None):
        if cfg.max_seq_len > model_cfg.seq_len:
            raise ValueError(
                f"max_seq_len {cfg.max_seq_len} exceeds the model's position "
                f"table ({model_cfg.seq_len})"
            )
        self.device = resolve_device(device)
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if impl == "kernel" and self.device.type != "cuda":
            raise ValueError("impl='kernel' needs a CUDA device")
        self._impl = impl
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.layout = kvcache.PagedLayout(
            n_layers=model_cfg.n_layers,
            n_pages=cfg.num_pages,
            page_size=cfg.page_size,
            kv_dim=model_cfg.n_heads * model_cfg.head_dim,
            dtype_name=cfg.cache_dtype,
        )
        on_kernels = (impl or ("kernel" if self.device.type == "cuda"
                               else "torch")) == "kernel"
        # decode reads fp32 pools in place where attention runs on K2 at a
        # head dim its decode path is built for; elsewhere on K2, and on fp8
        # pages, it runs the contiguous kernel on a gathered copy
        self._paged = (on_kernels and model_cfg.head_dim in DECODE_HEAD_DIMS
                       and not self.layout.quantized)
        self._gathered_on_k2 = on_kernels and not self._paged
        compute = cfg.compute_dtype or cfg.weights_dtype
        self._compute_dtype = (
            _torch_dtype(compute) if compute is not None else model_cfg.dtype
        )
        if cfg.weights_dtype is not None:
            params = cast_floats(params, _torch_dtype(cfg.weights_dtype))
        self._params = _to_device(params, self.device)
        # tied vocab head, widened once: an exact copy of the compute-dtype
        # embedding, so the head's fp32 product returns UNROUNDED fp32 logits
        self._head = self._params["tok_embed"].to(self._compute_dtype).float()
        self._cache = kvcache.alloc_cache(self.layout, self.device)
        # the hard gate: every entry strict against its DECLARED budget
        self._prefill_gated, self._decode_gated, self._copy_gated = (
            track_compiles(
                f"{cfg.entry_prefix}.{kind}", strict=cfg.strict_buckets,
                max_signatures=budget,
            )(functools.partial(self._run, kind))
            for kind, budget in (
                ("prefill", cfg.declared_prefill_signatures),
                ("decode", cfg.declared_decode_signatures),
                ("copy", cfg.declared_copy_signatures),
            )
        )

    # -- device-side steps ---------------------------------------------------

    def _ln(self, x, w, b):
        return fused_layer_norm(x, w, b, impl=self._impl)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: v[i] for k, v in self._params["blocks"].items()}

    def _embed(self, tokens, pos):
        p = self._params
        x = p["tok_embed"][tokens] + p["pos_embed"][pos]
        return x.to(self._compute_dtype)

    def _qkv(self, lp, x):
        h = self._ln(x, lp["ln1_scale"], lp["ln1_bias"])
        qkv = fused_dense(h, lp["wqkv"].to(h.dtype), lp["bqkv"].to(h.dtype))
        return qkv.chunk(3, dim=-1)

    def _heads(self, t):
        B, S, _ = t.shape
        mc = self.model_cfg
        return t.reshape(B, S, mc.n_heads, mc.head_dim).transpose(1, 2)

    @property
    def _scale(self) -> float:
        return 1.0 / math.sqrt(self.model_cfg.head_dim)

    def _attention(self, q, k, v, *, causal, kv_lens):
        """(B, S, H*hd) q, k, v -> the (B, S, H*hd) attention context."""
        ctx = flash_attention(
            self._heads(q), self._heads(k), self._heads(v), causal=causal,
            scale=self._scale, kv_lens=kv_lens, impl=self._impl,
        )
        B, H, S, hd = ctx.shape
        return ctx.transpose(1, 2).reshape(B, S, H * hd)

    def _decode_attention(self, q, kp, vp, page_table, kv_lens, kv_max):
        """One query row a sequence against one layer's pools: K2 reading the
        pages in place (no more than ``kv_max`` keys a sequence), or a
        gathered copy narrowed to q's dtype (exact: the fp32 pools hold
        compute-dtype values write_token widened) on K2's contiguous mode or
        the plain version. ``kp``/``vp`` may also be the gathered,
        dequantized fp32 copies of fp8 pages: a dequantized value is any
        fp32 value, so attention runs in fp32 on them, q widened exactly,
        and the context is rounded to q's dtype."""
        if self.layout.quantized:
            fwd = flash_fwd_kernel if self._gathered_on_k2 else flash_fwd_torch
            o, _ = _decode_contiguous(fwd, q.float(), kp, vp, kv_lens,
                                      self.model_cfg.n_heads, self._scale)
            return o.to(q.dtype)
        args = (q, kp, vp, page_table, kv_lens, self.model_cfg.n_heads,
                self._scale)
        if self._paged:
            return _paged_decode_kernel(*args, kv_max=kv_max)[0]
        if self._gathered_on_k2:
            return _decode_gathered(flash_fwd_kernel, *args)[0]
        return _paged_decode_torch(*args)[0]

    def _out_and_mlp(self, lp, x, ctx):
        x = x + fused_dense(ctx, lp["wo"].to(x.dtype), lp["bo"].to(x.dtype))
        h = self._ln(x, lp["ln2_scale"], lp["ln2_bias"])
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(fused_dense(h, lp["wi"].to(h.dtype), lp["bi"].to(h.dtype)),
                   approximate="tanh")
        return x + fused_dense(h, lp["wo2"].to(x.dtype), lp["bo2"].to(x.dtype))

    def _final_logits(self, x_last):
        """x_last (B, D) → fp32 logits (B, V) and greedy tokens."""
        p = self._params
        x_last = self._ln(x_last, p["lnf_scale"], p["lnf_bias"])
        logits = torch.matmul(x_last.float(), self._head.t())
        return logits.argmax(dim=-1).to(torch.int32), logits

    def _prefill_fn(self, tokens, lens, page_table):
        """tokens (B, S_bucket), lens (B,), page_table (B, n_slots).
        Returns (next_tokens (B,), last_logits (B, V) fp32)."""
        B, S = tokens.shape
        x = self._embed(tokens, torch.arange(S, device=self.device))
        c = self._cache
        for i in range(self.model_cfg.n_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(lp, x)
            # attention runs on the exact k and v either way: fp8 pages
            # change what later decode steps read
            if self.layout.quantized:
                kvcache.write_prefill_quantized(c.k[i], c.k_scale[i], page_table, k)
                kvcache.write_prefill_quantized(c.v[i], c.v_scale[i], page_table, v)
            else:
                kvcache.write_prefill(c.k[i], page_table, k)
                kvcache.write_prefill(c.v[i], page_table, v)
            x = self._out_and_mlp(
                lp, x, self._attention(q, k, v, causal=True, kv_lens=lens))
        last = (lens.long() - 1).clamp(0, S - 1)
        return self._final_logits(x[torch.arange(B, device=self.device), last])

    def _decode_fn(self, tokens, lens, page_table, lens_host):
        """One incremental token. tokens (B,) = the last sampled token per
        row, lens (B,) = tokens already cached (the fed token's position);
        inactive rows carry lens == 0 and a null page table and are fully
        masked. lens_host: lens as a host array, which bounds the keys the
        paged kernel reads. On fp8 pages the fed token is written under its
        page's scale (a fresh one where it opens the page) and attention reads
        the gathered, dequantized fp32 copy. Returns (next_tokens (B,),
        logits (B, V) fp32)."""
        x = self._embed(tokens, lens)[:, None, :]  # (B, 1, D)
        kv_lens = torch.where(lens > 0, lens + 1, 0)
        longest = int(lens_host.max(initial=0))
        kv_max = longest + 1 if longest > 0 else 0
        c = self._cache
        for i in range(self.model_cfg.n_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(lp, x)
            kp, vp = c.k[i], c.v[i]
            if self.layout.quantized:
                kvcache.write_token_quantized(kp, c.k_scale[i], page_table, lens,
                                              k[:, 0, :])
                kvcache.write_token_quantized(vp, c.v_scale[i], page_table, lens,
                                              v[:, 0, :])
                kp = kvcache.gather_pages_quantized(kp, c.k_scale[i], page_table)
                vp = kvcache.gather_pages_quantized(vp, c.v_scale[i], page_table)
            else:
                kvcache.write_token(kp, page_table, lens, k[:, 0, :])
                kvcache.write_token(vp, page_table, lens, v[:, 0, :])
            x = self._out_and_mlp(
                lp, x, self._decode_attention(q, kp, vp, page_table, kv_lens,
                                              kv_max))
        return self._final_logits(x[:, 0, :])

    def _copy_fn(self, src, dst):
        """Whole-page duplication ``dst[i] <- src[i]`` across all layers,
        k and v pools (and scale planes); 0 → 0 copies of the padding are
        no-ops."""
        c = self._cache
        for pool in (c.k, c.v, c.k_scale, c.v_scale):
            if pool is not None:
                pool = kvcache._bytes(pool)
                pool[:, dst] = pool[:, src]

    @torch.no_grad()
    def _run(self, kind, *argv):
        fn = {"prefill": self._prefill_fn, "decode": self._decode_fn,
              "copy": self._copy_fn}[kind]
        return fn(*argv)

    @property
    def compiled_signatures(self) -> int:
        """Distinct padded signatures the entry points have run — compared
        against ``cfg.declared_signatures``."""
        return sum(len(g.signatures) for g in self._gates)

    @property
    def call_counts(self) -> Dict[str, int]:
        """Calls that reached each gated entry point (prefill, decode,
        copy)."""
        return {kind: g.calls for kind, g in zip(
            ("prefill", "decode", "copy"), self._gates)}

    @property
    def _gates(self):
        return (self._prefill_gated, self._decode_gated, self._copy_gated)

    def reset_cache(self) -> None:
        """Zero the pools (and reset the scales) in place, for test and bench
        isolation."""
        self._cache.reset()

    # -- host surface --------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pad_tables(self, page_tables: Sequence[Sequence[int]], B: int):
        pt = np.zeros((B, self.cfg.n_slots), np.int32)  # the kernel's table
        for i, row in enumerate(page_tables):
            if len(row) > self.cfg.n_slots:
                raise ValueError(
                    f"request {i}: {len(row)} pages > {self.cfg.n_slots} slots"
                )
            pt[i, : len(row)] = row
        return self._tensor(pt)

    def prefill(self, prompts: Sequence[Sequence[int]],
                page_tables: Sequence[Sequence[int]]) -> np.ndarray:
        """Run ``n`` prompts through the bucketed prefill; returns the first
        generated token per request, (n,) int32 on host."""
        n = len(prompts)
        if n == 0:
            return np.zeros((0,), np.int32)
        if n != len(page_tables):
            raise ValueError(f"{n} prompts vs {len(page_tables)} page tables")
        B = pick_bucket(n, self.cfg.batch_buckets)
        longest = max(len(p) for p in prompts)
        if longest < 1:
            raise ValueError("empty prompt")
        S = pick_bucket(longest, self.cfg.prefill_seq_buckets)
        tokens = np.zeros((B, S), np.int64)
        lens = np.zeros((B,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lens[i] = len(p)
        nxt, _ = self._prefill_gated(
            self._tensor(tokens), self._tensor(lens), self._pad_tables(page_tables, B)
        )
        return nxt[:n].cpu().numpy()

    def _decode_args(self, tokens, lens, page_tables):
        n = len(tokens)
        if not (n == len(lens) == len(page_tables)):
            raise ValueError("tokens/lens/page_tables length mismatch")
        B = pick_bucket(n, self.cfg.decode_buckets)
        tok = np.zeros((B,), np.int64)
        ln = np.zeros((B,), np.int32)  # kv_lens, as the paged kernel takes them
        tok[:n] = tokens
        ln[:n] = lens
        if ln[:n].max() >= self.cfg.max_seq_len:
            raise ValueError(f"decode past max_seq_len {self.cfg.max_seq_len}")
        return (self._tensor(tok), self._tensor(ln),
                self._pad_tables(page_tables, B), ln)

    def decode(self, tokens: Sequence[int], lens: Sequence[int],
               page_tables: Sequence[Sequence[int]]) -> np.ndarray:
        """One decode step for ``n`` active requests; returns (n,) int32."""
        n = len(tokens)
        if n == 0:
            return np.zeros((0,), np.int32)
        nxt, _ = self._decode_gated(*self._decode_args(tokens, lens, page_tables))
        return nxt[:n].cpu().numpy()

    def decode_logits(self, tokens: Sequence[int], lens: Sequence[int],
                      page_tables: Sequence[Sequence[int]]) -> np.ndarray:
        """Decode step that also returns the (n, V) fp32 logits — the
        correctness-oracle surface; same signatures as :meth:`decode`."""
        n = len(tokens)
        _, logits = self._decode_gated(
            *self._decode_args(tokens, lens, page_tables))
        return logits[:n].cpu().numpy()

    def copy_pages(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Duplicate whole pages ``src[i] → dst[i]`` inside the pools, padded
        to ``max_batch`` with the null page (one declared signature)."""
        n = len(src)
        if n == 0:
            return
        if n != len(dst):
            raise ValueError(f"{n} src pages vs {len(dst)} dst pages")
        if n > self.cfg.max_batch:
            raise ValueError(
                f"copy_pages({n}) exceeds max_batch {self.cfg.max_batch}"
            )
        s = np.zeros((self.cfg.max_batch,), np.int64)
        d = np.zeros((self.cfg.max_batch,), np.int64)
        s[:n] = src
        d[:n] = dst
        self._copy_gated(self._tensor(s), self._tensor(d))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
