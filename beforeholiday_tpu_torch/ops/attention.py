"""Flash-attention forward on kernel K2 (CUDA C++, ``csrc/flash_fwd.cu``).

K2 replaces ``beforeholiday_tpu/ops/attention.py:152`` ``_fa_fwd_kernel``
(mask predicate ``:119``, launched at ``:244``); its header states the bound
on an H100 and what the design does about it. Unlike the TPU kernel, which
needs both sequence lengths to tile by 128, K2 takes every shape the serving
engine sends, decode's ``Sq=1`` against the whole gathered cache included.

The wrappers keep the JAX module's layout at the public functions:
:func:`flash_attention` takes ``(B, H, S, D)`` and per-sequence ``kv_lens``,
:func:`flash_attention_with_lse` takes the ``(BH, S, D)`` view and also
returns ``lse`` as ``(BH, S)``. Only the forward is ported: dropout and the
backward kernels (``_fa_dq_kernel``, ``_fa_dkv_kernel``) belong to the
training slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from beforeholiday_tpu_torch import _build
from beforeholiday_tpu_torch.ops._dispatch import resolve_impl

_NEG = -1e30  # mask fill; large-negative (not -inf) keeps exp/max NaN-free
_MIN_BLOCK = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = tuple(range(16, 129, 16))
_MAX_GRID_Y = 65535


def _block_size(seq_len: int, head_dim: int = 64) -> int:
    """The TPU kernel's block (query rows == key cols) for ``seq_len``; kept
    with the JAX semantics for API parity. K2 tiles by its own constants."""
    ladder = (1024, 512, 256) if head_dim <= 128 else (512, 256)
    for cand in ladder:
        if seq_len % cand == 0:
            return cand
    return _MIN_BLOCK


def is_flash_available(seq_len: int, head_dim: int) -> bool:
    """The TPU kernel's shape gate, with the JAX semantics (API parity). K2
    itself takes any length and head dims 16..128 in steps of 16."""
    return seq_len % _MIN_BLOCK == 0 and 8 <= head_dim <= 512


def flash_fwd_torch(q, k, v, lens, causal: bool, scale: float):
    """Plain PyTorch version of K2: ``(o, lse)`` for ``q (BH, Sq, D)``,
    ``k, v (BH, Sk, D)`` and integer ``lens (BH,)``. Computes in fp32 and
    returns ``o`` in q's dtype (the JAX oracle's contract)."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    kj = torch.arange(Sk, device=q.device)
    masked = kj[None, None, :] >= lens.to(q.device)[:, None, None]
    if causal:
        masked = masked | (kj[None, :] > torch.arange(Sq, device=q.device)[:, None])
    s = s.masked_fill(masked, _NEG)
    m = s.amax(-1, keepdim=True) if Sk else s.new_full((*s.shape[:2], 1), _NEG)
    # explicit zero on masked slots: on a fully masked row s == m == _NEG
    e = torch.where(masked, 0.0, torch.exp(s - m))
    l = e.sum(-1, keepdim=True)
    nonempty = l > 0.0
    safe_l = torch.where(nonempty, l, 1.0)
    p = torch.where(nonempty, e / safe_l, 0.0)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    lse = torch.where(nonempty, m + torch.log(safe_l), _NEG)[..., 0]
    return o, lse


@functools.cache
def _flash_lib():
    fn = _build.load("flash_fwd").flash_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_kernel(q, k, v, lens, causal: bool, scale: float):
    """Launch K2 on CUDA tensors; returns ``(o, lse)``. Checks device, dtype,
    shape and layout and raises on anything the kernel does not take."""
    tensors = (q, k, v, lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("K2 takes q, k, v and lens on one CUDA device")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"K2 takes q (BH, Sq, D), k = v (BH, Sk, D); got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != D or lens.shape != (BH,):
        raise ValueError(f"K2 shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, lens {tuple(lens.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"K2 takes one dtype of {list(_KERNEL_DTYPES)} for q, "
                         f"k, v; got {q.dtype}/{k.dtype}/{v.dtype}")
    if lens.dtype != torch.int32:
        raise ValueError(f"K2 takes int32 lens, got {lens.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"K2 takes head dims {_KERNEL_HEAD_DIMS}, got {D}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"K2 grids BH on y: {BH} > {_MAX_GRID_Y}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K2 takes contiguous q, k, v and lens")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K2 reads q, k, v in 16-byte vectors: align them")
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    if BH == 0 or Sq == 0:
        return o, lse
    fn = _flash_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
                BH, Sq, Sk, D, float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"K2 (flash_fwd) launch failed with CUDA error {rc}")
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lens, causal, scale, impl):
        fn = flash_fwd_kernel if impl == "kernel" else flash_fwd_torch
        return fn(q, k, v, lens, causal, scale)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet"
        )


def _lens_int32(kv_lens, n: int, default: int, device) -> torch.Tensor:
    if kv_lens is None:
        return torch.full((n,), default, dtype=torch.int32, device=device)
    if kv_lens.is_floating_point():
        # the JAX mask compares k >= len in float: a fractional length keeps
        # key ceil(len) - 1
        kv_lens = torch.ceil(kv_lens)
    return kv_lens.to(device=device, dtype=torch.int32)


def flash_attention_with_lse(q3: torch.Tensor, k3: torch.Tensor,
                             v3: torch.Tensor, *, causal: bool, scale: float,
                             kv_lens: Optional[torch.Tensor] = None,
                             impl: Optional[str] = None):
    """``(BH, S, D)`` flash attention returning ``(o, lse (BH, S))``. Fully
    masked rows carry ``lse = -1e30`` and ``o = 0``."""
    impl = resolve_impl(impl, q3)
    lens = _lens_int32(kv_lens, q3.shape[0], k3.shape[1], q3.device)
    return _FlashForward.apply(q3.contiguous(), k3.contiguous(),
                               v3.contiguous(), lens.contiguous(),
                               bool(causal), float(scale), impl)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_key=None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Fused scaled-dot-product attention over ``(B, H, S, D)`` inputs.

    ``kv_lens``: optional ``(B,)`` key lengths; keys at index ``>= len`` are
    masked out. Returns ``(B, H, S, D)`` in q's dtype with fp32 accumulation.
    On CUDA tensors q, k and v must share a dtype; the plain path (CPU, or
    ``impl="torch"``) also takes mixed dtypes and computes in fp32."""
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, D) inputs, got {tuple(q.shape)}")
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != D:
        raise ValueError(f"q/k/v shapes mismatch, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(
            f"causal attention needs matching q/k lengths, got {S} vs {Sk}"
        )
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is training-only and not ported yet"
        )
    lens = _lens_int32(kv_lens, B, Sk, q.device).repeat_interleave(H)
    o, _ = flash_attention_with_lse(
        q.reshape(B * H, S, D), k.reshape(B * H, Sk, D),
        v.reshape(B * H, Sk, D), causal=causal, scale=scale, kv_lens=lens,
        impl=impl,
    )
    return o.reshape(B, H, S, D)
