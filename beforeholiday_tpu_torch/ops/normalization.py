"""Fused LayerNorm / RMSNorm forward on kernel K1 (Triton).

K1 replaces ``beforeholiday_tpu/ops/normalization.py:55`` ``_ln_fwd_kernel``
(launched at ``:112``). It computes the same function: per row the mean and
variance (or the mean square for RMSNorm) in fp32 whatever the storage dtype,
then ``xhat * w + b`` written in the dtype the caller chose.

Bound on an H100: bytes. At the serving prefill shape (8192 x 1024 bf16) one
call must move 33.6 MB (x read once, y written once), 10.0 us at 3.35 TB/s,
against about 0.1 GFLOP of fp32 arithmetic. The design therefore makes one
pass over HBM: one program owns a block of whole rows, the full hidden width
sits in registers (``BLOCK = next_pow2(hidden)``, masked), the two row
reductions and the affine pass run on that register copy, and each element is
read once and written once. ``rms`` and the bias are compile-time switches;
``eps`` is a runtime scalar.

Only the forward is ported. The backward (``_ln_bwd_kernel``) belongs to the
training slice, so differentiating through these functions raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# widest row K1 keeps in registers (BLOCK elements x ROWS rows per program)
_MAX_BLOCK = 16384


def ln_fwd_torch(x2d, w, b, eps: float, rms: bool, out_dtype):
    """Plain PyTorch version of K1: the CPU path and the kernel's yardstick."""
    x = x2d.float()
    if rms:
        xhat = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    else:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        xhat = (x - mu) * torch.rsqrt(var + eps)
    y = xhat * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


@functools.cache
def _ln_fwd_triton():
    # ``tl`` is bound as a module global so that the kernel body and its
    # constexpr annotations resolve it the way Triton looks names up
    global tl
    from beforeholiday_tpu_torch._build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(X, W, B, Y, n_rows, n_cols, stride_x, stride_y, eps,
                RMS: tl.constexpr, HAS_BIAS: tl.constexpr,
                BLOCK: tl.constexpr, ROWS: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        cmask = cols < n_cols
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        rows64 = rows.to(tl.int64)[:, None]
        x = tl.load(X + rows64 * stride_x + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        if RMS:
            var = tl.sum(x * x, axis=1) / n_cols
            xhat = x * tl.rsqrt(var + eps)[:, None]
        else:
            mean = tl.sum(x, axis=1) / n_cols
            xc = tl.where(mask, x - mean[:, None], 0.0)
            var = tl.sum(xc * xc, axis=1) / n_cols
            xhat = xc * tl.rsqrt(var + eps)[:, None]
        w = tl.load(W + cols, mask=cmask, other=0.0).to(tl.float32)
        y = xhat * w[None, :]
        if HAS_BIAS:
            b = tl.load(B + cols, mask=cmask, other=0.0).to(tl.float32)
            y = y + b[None, :]
        tl.store(Y + rows64 * stride_y + cols[None, :],
                 y.to(Y.dtype.element_ty), mask=mask)

    return triton, _ln_fwd


def ln_fwd_kernel(x2d, w, b, eps: float, rms: bool, out_dtype):
    """Launch K1 on CUDA tensors. Checks device, dtype, shape and layout and
    raises on anything the kernel does not take."""
    if x2d.ndim != 2 or not x2d.is_cuda:
        raise ValueError(f"K1 takes a 2-D CUDA tensor, got {tuple(x2d.shape)} "
                         f"on {x2d.device}")
    rows, hidden = x2d.shape
    params = [w] if b is None else [w, b]
    for t in params:
        if t.device != x2d.device or t.shape != (hidden,):
            raise ValueError(f"K1 params must be ({hidden},) on {x2d.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    for t in (x2d, out_dtype, *params):
        dt = t if isinstance(t, torch.dtype) else t.dtype
        if dt not in _KERNEL_DTYPES:
            raise ValueError(f"K1 does not take dtype {dt}")
    if x2d.stride(1) != 1 or any(not t.is_contiguous() for t in params):
        raise ValueError("K1 needs unit-stride rows and contiguous params")
    triton, kernel = _ln_fwd_triton()
    block = triton.next_power_of_2(hidden)
    if block > _MAX_BLOCK:
        raise ValueError(f"hidden {hidden} exceeds K1's widest row {_MAX_BLOCK}")
    n_rows = max(1, 4096 // block)
    y = torch.empty((rows, hidden), dtype=out_dtype, device=x2d.device)
    if rows:
        kernel[(triton.cdiv(rows, n_rows),)](
            x2d, w, w if b is None else b, y, rows, hidden,
            x2d.stride(0), y.stride(0), float(eps),
            RMS=rms, HAS_BIAS=b is not None, BLOCK=block, ROWS=n_rows,
            num_warps=4 if block * n_rows <= 4096 else 8,
        )
        ln_fwd_kernel.launches += 1
    return y


ln_fwd_kernel.launches = 0


class _NormForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, eps, rms, out_dtype, impl):
        fn = ln_fwd_kernel if impl == "kernel" else ln_fwd_torch
        return fn(x2d, w, b, eps, rms, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "the LayerNorm backward (_ln_bwd_kernel) is not ported yet"
        )


def _norm_impl(x, weight, bias, eps, rms, out_dtype, impl):
    impl = resolve_impl(impl, x)
    hidden = x.shape[-1]
    if weight.shape != (hidden,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({hidden},)")
    if bias is not None and bias.shape != (hidden,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({hidden},)")
    x2d = x.reshape(-1, hidden)
    y = _NormForward.apply(x2d, weight, bias, float(eps), rms, out_dtype, impl)
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                     memory_efficient: bool = False,
                     impl: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last dim; output dtype = input dtype.
    ``memory_efficient`` is accepted for API parity."""
    return _norm_impl(x, weight, bias, eps, False, x.dtype, impl)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
                   memory_efficient: bool = False,
                   impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dim; output dtype = input dtype."""
    return _norm_impl(x, weight, None, eps, True, x.dtype, impl)


def mixed_dtype_fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None, *,
                                 eps: float = 1e-5,
                                 impl: Optional[str] = None) -> torch.Tensor:
    """LayerNorm whose output dtype follows the parameter dtype."""
    return _norm_impl(x, weight, bias, eps, False, weight.dtype, impl)


def mixed_dtype_fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
                               eps: float = 1e-5,
                               impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm whose output dtype follows the parameter dtype."""
    return _norm_impl(x, weight, None, eps, True, weight.dtype, impl)
