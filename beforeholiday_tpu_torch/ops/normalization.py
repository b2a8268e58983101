"""Fused LayerNorm / RMSNorm on kernels K1 (forward) and K3 (backward),
both Triton.

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

K3 replaces ``_ln_bwd_kernel`` (``:69``, launched by ``_ln_bwd_pallas`` at
``:134``): dx in closed form from (mean, invvar) recomputed from x, as the
TPU kernel does (``:185-210``), and dgamma/dbeta summed over rows. The TPU
sums dgamma/dbeta across its sequential grid in one VMEM block; a GPU grid
runs in no order, so K3 is two launches: a fixed number of programs each walk
a strided set of row blocks (whole rows in registers, K1's design) and write
one fp32 partial row of dgamma and dbeta, then a second program per column
block sums the partials in a fixed order. No atomics, so the result does not
depend on the schedule. It takes the O5 mix (bf16 x and dy, fp32 w): dx comes
back in x's dtype, dgamma/dbeta in w's. Bound at the training shape
(16384 x 1024, bf16 x/dy/dx, fp32 w): 100.7 MB, 0.030 ms at 3.35 TB/s.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from beforeholiday_tpu_torch.ops._autocast import float_function
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


def ln_bwd_torch(x2d, w, dy, eps: float, rms: bool):
    """Plain PyTorch version of K3: ``(dx in x's dtype, dw, db)`` with dw/db
    in fp32 (the caller casts them to the parameter dtype)."""
    x, dyf, wf = x2d.float(), dy.float(), w.float()
    if rms:
        r = torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
        xhat = x * r
        dyw = dyf * wf
        dx = r * (dyw - xhat * (dyw * xhat).mean(-1, keepdim=True))
    else:
        mu = x.mean(-1, keepdim=True)
        r = torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + eps)
        xhat = (x - mu) * r
        dyw = dyf * wf
        m1 = dyw.mean(-1, keepdim=True)
        m2 = (dyw * xhat).mean(-1, keepdim=True)
        dx = r * (dyw - m1 - xhat * m2)
    return dx.to(x2d.dtype), (dyf * xhat).sum(0), dyf.sum(0)


# programs of K3's first stage: each walks a strided set of row blocks, so
# the partial buffer is at most this many rows whatever the row count
_BWD_PROGRAMS = 512
_REDUCE_COLS = 64


@functools.cache
def _ln_bwd_triton():
    global tl
    from beforeholiday_tpu_torch._build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_bwd(X, W, DY, DX, PW, PB, n_rows, n_cols, stride_x, stride_dy,
                stride_dx, eps, RMS: tl.constexpr, HAS_BIAS: tl.constexpr,
                BLOCK: tl.constexpr, ROWS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        cmask = cols < n_cols
        w = tl.load(W + cols, mask=cmask, other=0.0).to(tl.float32)
        dw_acc = tl.zeros([BLOCK], dtype=tl.float32)
        db_acc = tl.zeros([BLOCK], dtype=tl.float32)
        for blk in range(pid, tl.cdiv(n_rows, ROWS), tl.num_programs(0)):
            rows = blk * ROWS + tl.arange(0, ROWS)
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            rows64 = rows.to(tl.int64)[:, None]
            x = tl.load(X + rows64 * stride_x + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            dy = tl.load(DY + rows64 * stride_dy + cols[None, :], mask=mask,
                         other=0.0).to(tl.float32)
            dyw = dy * w[None, :]
            if RMS:
                r = tl.rsqrt(tl.sum(x * x, axis=1) / n_cols + eps)
                xhat = x * r[:, None]
                m2 = tl.sum(dyw * xhat, axis=1) / n_cols
                dx = r[:, None] * (dyw - xhat * m2[:, None])
            else:
                mean = tl.sum(x, axis=1) / n_cols
                xc = tl.where(mask, x - mean[:, None], 0.0)
                r = tl.rsqrt(tl.sum(xc * xc, axis=1) / n_cols + eps)
                xhat = xc * r[:, None]
                m1 = tl.sum(dyw, axis=1) / n_cols
                m2 = tl.sum(dyw * xhat, axis=1) / n_cols
                dx = r[:, None] * (dyw - m1[:, None] - xhat * m2[:, None])
            tl.store(DX + rows64 * stride_dx + cols[None, :],
                     dx.to(DX.dtype.element_ty), mask=mask)
            dw_acc += tl.sum(dy * xhat, axis=0)
            if HAS_BIAS:
                db_acc += tl.sum(dy, axis=0)
        tl.store(PW + pid * n_cols + cols, dw_acc, mask=cmask)
        if HAS_BIAS:
            tl.store(PB + pid * n_cols + cols, db_acc, mask=cmask)

    @triton.jit
    def _ln_bwd_reduce(PW, PB, DW, DB, n_part, n_cols, HAS_BIAS: tl.constexpr,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < n_cols
        dw = tl.zeros([BLOCK_C], dtype=tl.float32)
        db = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r0 in range(0, n_part, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < n_part)[:, None] & cmask[None, :]
            offs = rows[:, None] * n_cols + cols[None, :]
            dw += tl.sum(tl.load(PW + offs, mask=mask, other=0.0), axis=0)
            if HAS_BIAS:
                db += tl.sum(tl.load(PB + offs, mask=mask, other=0.0), axis=0)
        tl.store(DW + cols, dw.to(DW.dtype.element_ty), mask=cmask)
        if HAS_BIAS:
            tl.store(DB + cols, db.to(DB.dtype.element_ty), mask=cmask)

    return triton, _ln_bwd, _ln_bwd_reduce


def ln_bwd_kernel(x2d, w, dy, eps: float, rms: bool, has_bias: bool = True):
    """Launch K3 on CUDA tensors: ``(dx in x's dtype, dw, db in w's dtype)``,
    ``db`` None without a bias. Checks device, dtype, shape and layout and
    raises on anything the kernel does not take."""
    if x2d.ndim != 2 or not x2d.is_cuda:
        raise ValueError(f"K3 takes a 2-D CUDA tensor, got {tuple(x2d.shape)} "
                         f"on {x2d.device}")
    rows, hidden = x2d.shape
    if dy.shape != x2d.shape or dy.device != x2d.device:
        raise ValueError(f"K3 dy must match x {tuple(x2d.shape)} on "
                         f"{x2d.device}, got {tuple(dy.shape)} on {dy.device}")
    if w.device != x2d.device or w.shape != (hidden,):
        raise ValueError(f"K3 weight must be ({hidden},) on {x2d.device}")
    for dt in (x2d.dtype, dy.dtype, w.dtype):
        if dt not in _KERNEL_DTYPES:
            raise ValueError(f"K3 does not take dtype {dt}")
    if x2d.stride(1) != 1 or dy.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("K3 needs unit-stride rows and a contiguous weight")
    triton, kernel, reduce = _ln_bwd_triton()
    block = triton.next_power_of_2(hidden)
    if block > _MAX_BLOCK:
        raise ValueError(f"hidden {hidden} exceeds K3's widest row {_MAX_BLOCK}")
    n_rows = max(1, 2048 // block)
    dx = torch.empty((rows, hidden), dtype=x2d.dtype, device=x2d.device)
    dw = torch.empty((hidden,), dtype=w.dtype, device=x2d.device)
    db = torch.empty((hidden,), dtype=w.dtype, device=x2d.device) if has_bias else None
    progs = max(1, min(_BWD_PROGRAMS, triton.cdiv(rows, n_rows)))
    pw = torch.empty((progs, hidden), dtype=torch.float32, device=x2d.device)
    pb = torch.empty_like(pw) if has_bias else pw
    kernel[(progs,)](
        x2d, w, dy, dx, pw, pb, rows, hidden, x2d.stride(0), dy.stride(0),
        dx.stride(0), float(eps), RMS=rms, HAS_BIAS=has_bias, BLOCK=block,
        ROWS=n_rows, num_warps=4 if block * n_rows <= 2048 else 8,
    )
    reduce[(triton.cdiv(hidden, _REDUCE_COLS),)](
        pw, pb, dw, dw if db is None else db, progs, hidden, HAS_BIAS=has_bias,
        BLOCK_R=32, BLOCK_C=_REDUCE_COLS, num_warps=4,
    )
    ln_bwd_kernel.launches += 1
    return dx, dw, db


ln_bwd_kernel.launches = 0


class _NormForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, eps, rms, out_dtype, impl):
        ctx.save_for_backward(x2d, w)
        ctx.eps, ctx.rms, ctx.impl, ctx.has_bias = eps, rms, impl, b is not None
        fn = ln_fwd_kernel if impl == "kernel" else ln_fwd_torch
        return fn(x2d, w, b, eps, rms, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        if ctx.impl == "kernel":
            dx, dw, db = ln_bwd_kernel(x2d, w, dy.contiguous(), ctx.eps,
                                       ctx.rms, ctx.has_bias)
        else:
            dx, dw, db = ln_bwd_torch(x2d, w, dy, ctx.eps, ctx.rms)
            dw = dw.to(w.dtype)
            db = db.to(w.dtype) if ctx.has_bias else None
        return dx, dw, db, None, None, None, None


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


@float_function
def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                     memory_efficient: bool = False,
                     impl: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last dim; output dtype = input dtype.
    ``memory_efficient`` is accepted for API parity."""
    return _norm_impl(x, weight, bias, eps, False, x.dtype, impl)


@float_function
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
