"""Fused scale + mask + softmax family on kernels K11 (forward) and K12
(backward), both Triton — counterpart of ``beforeholiday_tpu/ops/softmax.py``
(Megatron's four softmax extensions: ``scaled_softmax``,
``scaled_masked_softmax``, ``generic_scaled_masked_softmax`` and
``scaled_upper_triang_masked_softmax``).

K11 replaces ``_softmax_fwd_kernel`` (``:48``, launched by ``_fwd_pallas`` at
``:77``): per row of attention scores, ``s = x * scale``, the mask filled
with -10000 (not -inf: a row whose every key is masked comes out uniform
1/sk), then a softmax with fp32 max, exp and sum whatever the storage dtype.
K12 replaces ``_softmax_bwd_kernel`` (``:63``, launched at ``:95``):
``dx = scale * y * (dy - sum(dy * y))`` with the row sum in fp32.

Bound on an H100: bytes. Each is a row reduction fused with one elementwise
pass and no tensor-core work, so the design makes one pass over HBM: one
program owns whole rows held in registers (``BLOCK = next_pow2(sk)``, the
padding columns beyond sk set to -inf so they drop out of the max and the
sum), several rows per program when rows are narrow, as K1 does. K11 reads x
once and writes y once; K12 reads y and dy once and writes dx once. At the
GPT causal shape (262,144 rows of 1024, bf16) K11 moves 1.07 GB, 0.32 ms at
3.35 TB/s, and K12 1.61 GB, 0.48 ms. Rows up to 16384 wide (the
``FusedScaleMaskSoftmax`` limit) fit; wider ones raise.

Where the TPU kernel differs:
- The causal fill comes from the row index (query = row % sq), so K11 takes
  any sq; the TPU kernel needs its 128-row tiles aligned with the sequence
  and its wrapper sends other sq to the jnp path.
- The explicit mask is read inside K11 (and K12) through its own strides:
  row r is (b, h, q) = (r // (H·sq), (r // sq) % H, r % sq), so a
  (B, 1, 1, sk) key-padding mask or a (B, 1, sq, sk) mask is never expanded
  per head in memory. JAX writes the filled fp32 scores to HBM outside its
  kernel (``:198``) and runs the kernel on them with scale 1; K11 computes
  the same function without those bytes.

The two variants keep JAX's orders and saved dtypes:
- scale-only and causal: y is written in x's dtype and that y is saved; the
  backward is ``scale * y * (dy - sum)`` in fp32, returned in dy's dtype.
- masked: JAX's kernel runs on fp32 filled scores, so the y its backward
  reads is fp32, rounded to x's dtype only for the caller. K11 writes both
  (the fp32 y is saved, 8 B an element with a bf16 x). The backward is
  ``where(mask, 0, y * (dy - sum)) * scale``, cast to x's dtype once: the
  kernel's VJP at scale 1, then ``jnp.where``'s, then the scale's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl

_MASK_VALUE = -10000.0  # the reference's additive fill
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# widest row K11/K12 keep in registers: the FusedScaleMaskSoftmax limit
_MAX_COLS = 16384
# elements of a program's block of rows, and rows per program at most
_BLOCK_ELEMS = 4096


def softmax_fwd_torch(x4, scale: float, causal: bool = False, mask4=None):
    """Plain PyTorch version of K11 over ``x4 (B, H, sq, sk)``: the CPU path
    and the kernel's yardstick. ``mask4`` (broadcastable to x4, nonzero =
    masked) or ``causal`` fills -10000 after the scale. Returns ``(y in x's
    dtype, fp32 y)``: the fp32 y, which the masked backward reads, only with
    a mask (``y`` itself when x is fp32), else None."""
    s = x4.float() * scale
    if causal:
        sq, sk = s.shape[-2:]
        k = torch.arange(sk, device=s.device)
        q = torch.arange(sq, device=s.device)
        s = torch.where(k[None, :] > q[:, None], _MASK_VALUE, s)
    if mask4 is not None:
        s = torch.where(mask4 != 0, _MASK_VALUE, s)
    if s.shape[-1]:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        y32 = e / e.sum(-1, keepdim=True)
    else:
        y32 = s
    y = y32.to(x4.dtype)
    if mask4 is None:
        return y, None
    return y, (y if x4.dtype == torch.float32 else y32)


def softmax_bwd_torch(y4, dy4, scale: float, mask4=None):
    """Plain PyTorch version of K12: ``scale * y * (dy - sum(dy * y))``, or
    with ``mask4`` ``where(mask, 0, y * (dy - sum)) * scale``, in fp32, cast
    to dy's dtype."""
    y, dy = y4.float(), dy4.float()
    s = (dy * y).sum(-1, keepdim=True)
    if mask4 is None:
        dx = scale * y * (dy - s)
    else:
        dx = torch.where(mask4 != 0, 0.0, y * (dy - s)) * scale
    return dx.to(dy4.dtype)


@functools.cache
def _softmax_triton():
    # ``tl`` and the helper ``_mask_at`` are bound as module globals so that
    # the kernel bodies and their constexpr annotations resolve them the way
    # Triton looks names up (in the function's globals)
    global tl, _mask_at
    from beforeholiday_tpu_torch._build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def _mask_at(M, rows, cols, valid, heads, sq, msb, msh, msq, msk):
        """The mask at (rows, cols) read through its strides: row r is
        (b, h, q) = (r // (heads * sq), (r // sq) % heads, r % sq)."""
        q = rows % sq
        bh = rows // sq
        moff = ((bh // heads).to(tl.int64) * msb + (bh % heads).to(tl.int64) * msh
                + q.to(tl.int64) * msq)
        m = tl.load(M + moff[:, None] + cols.to(tl.int64)[None, :] * msk,
                    mask=valid, other=0)
        return m != 0

    @triton.jit
    def _softmax_fwd(X, M, Y, Y32, n_rows, n_cols, heads, sq, msb, msh, msq,
                     msk, scale, MODE: tl.constexpr, HAS_Y32: tl.constexpr,
                     BLOCK: tl.constexpr, ROWS: tl.constexpr):
        # MODE: 0 scale only, 1 causal (query = row % sq), 2 explicit mask
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        cmask = cols < n_cols
        valid = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        s = tl.load(X + offs, mask=valid, other=0.0).to(tl.float32) * scale
        if MODE == 1:
            s = tl.where(cols[None, :] > (rows % sq)[:, None], -10000.0, s)
        if MODE == 2:
            s = tl.where(_mask_at(M, rows, cols, valid, heads, sq, msb, msh,
                                  msq, msk), -10000.0, s)
        # padding columns are not masked keys: they leave the max and the sum
        s = tl.where(cmask[None, :], s, float("-inf"))
        e = tl.exp(s - tl.max(s, axis=1)[:, None])
        y = e / tl.sum(e, axis=1)[:, None]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=valid)
        if HAS_Y32:
            tl.store(Y32 + offs, y, mask=valid)

    @triton.jit
    def _softmax_bwd(Y, DY, M, DX, n_rows, n_cols, heads, sq, msb, msh, msq,
                     msk, scale, MASKED: tl.constexpr, BLOCK: tl.constexpr,
                     ROWS: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        valid = (rows < n_rows)[:, None] & (cols < n_cols)[None, :]
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        y = tl.load(Y + offs, mask=valid, other=0.0).to(tl.float32)
        dy = tl.load(DY + offs, mask=valid, other=0.0).to(tl.float32)
        s = tl.sum(dy * y, axis=1)[:, None]
        if MASKED:
            m = _mask_at(M, rows, cols, valid, heads, sq, msb, msh, msq, msk)
            dx = tl.where(m, 0.0, y * (dy - s)) * scale
        else:
            dx = scale * y * (dy - s)
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=valid)

    return triton, _softmax_fwd, _softmax_bwd


def _launch_shape(triton, sk):
    """``(BLOCK, ROWS, num_warps)`` for rows of ``sk``: whole rows in
    registers, several per program when they are narrow."""
    block = triton.next_power_of_2(sk)
    rows = max(1, _BLOCK_ELEMS // block)
    return block, rows, max(4, min(16, block * rows // 512))


def _check(name, tensors, x4, mask4):
    """The checks K11 and K12 share. Returns the mask as the kernel reads it
    (bool viewed as uint8) and its four strides."""
    if x4.ndim != 4 or not x4.is_cuda:
        raise ValueError(f"{name} takes a 4-D CUDA tensor (B, H, sq, sk), got "
                         f"{tuple(x4.shape)} on {x4.device}")
    for t in tensors:
        if t.device != x4.device or t.shape != x4.shape:
            raise ValueError(f"{name} operands must be {tuple(x4.shape)} on "
                             f"{x4.device}, got {tuple(t.shape)} on {t.device}")
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"{name} does not take dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")
    if x4.shape[-1] > _MAX_COLS:
        raise ValueError(f"{name}: rows of {x4.shape[-1]} exceed the widest "
                         f"row {_MAX_COLS}")
    if mask4 is None:
        return x4, (0, 0, 0, 0)
    if mask4.device != x4.device or mask4.shape != x4.shape:
        raise ValueError(f"{name} takes the mask expanded to {tuple(x4.shape)} "
                         f"on {x4.device}, got {tuple(mask4.shape)} on "
                         f"{mask4.device}")
    if mask4.dtype == torch.bool:
        mask4 = mask4.view(torch.uint8)
    return mask4, mask4.stride()


def softmax_fwd_kernel(x4, scale: float, causal: bool = False, mask4=None):
    """Launch K11 on CUDA tensors; the plain version's contract. ``mask4``
    is the mask expanded to x4's shape (a view: stride 0 where it
    broadcasts). Checks device, dtype, shape and layout and raises on
    anything the kernel does not take."""
    if causal and mask4 is not None:
        raise ValueError("K11 takes a causal fill or a mask, not both")
    m, mstrides = _check("K11", (x4,), x4, mask4)
    B, H, sq, sk = x4.shape
    y = torch.empty(x4.shape, dtype=x4.dtype, device=x4.device)
    # with a mask the backward reads the fp32 y: a second output unless y is it
    two = mask4 is not None and x4.dtype != torch.float32
    y32 = torch.empty(x4.shape, dtype=torch.float32, device=x4.device) if two else None
    rows = B * H * sq
    if rows and sk:
        triton, kernel, _ = _softmax_triton()
        block, n_rows, warps = _launch_shape(triton, sk)
        kernel[(triton.cdiv(rows, n_rows),)](
            x4, m, y, y if y32 is None else y32, rows, sk, H, sq, *mstrides,
            float(scale), MODE=2 if mask4 is not None else int(causal),
            HAS_Y32=two, BLOCK=block, ROWS=n_rows, num_warps=warps)
        softmax_fwd_kernel.launches += 1
    if mask4 is None:
        return y, None
    return y, (y if y32 is None else y32)


softmax_fwd_kernel.launches = 0


def softmax_bwd_kernel(y4, dy4, scale: float, mask4=None):
    """Launch K12 on CUDA tensors; the plain version's contract. Checks
    device, dtype, shape and layout and raises on anything the kernel does
    not take."""
    m, mstrides = _check("K12", (y4, dy4), y4, mask4)
    B, H, sq, sk = y4.shape
    dx = torch.empty(y4.shape, dtype=dy4.dtype, device=y4.device)
    rows = B * H * sq
    if rows and sk:
        triton, _, kernel = _softmax_triton()
        block, n_rows, warps = _launch_shape(triton, sk)
        kernel[(triton.cdiv(rows, n_rows),)](
            y4, dy4, m, dx, rows, sk, H, sq, *mstrides, float(scale),
            MASKED=mask4 is not None, BLOCK=block, ROWS=n_rows,
            num_warps=warps)
        softmax_bwd_kernel.launches += 1
    return dx


softmax_bwd_kernel.launches = 0


def _fwd(impl):
    return softmax_fwd_kernel if impl == "kernel" else softmax_fwd_torch


def _bwd(impl):
    return softmax_bwd_kernel if impl == "kernel" else softmax_bwd_torch


class _ScaledSoftmax(torch.autograd.Function):
    """Scale-only and causal variants: y in x's dtype, and that y saved."""

    @staticmethod
    def forward(ctx, x4, scale, causal, impl):
        y, _ = _fwd(impl)(x4, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale, ctx.impl = scale, impl
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _bwd(ctx.impl)(y, dy.contiguous(), ctx.scale), None, None, None


class _ScaledMaskedSoftmax(torch.autograd.Function):
    """Masked variant: the fp32 y saved, y returned in x's dtype, and the
    backward's order of JAX's VJP (masked slots zeroed, then the scale,
    then one cast to x's dtype)."""

    @staticmethod
    def forward(ctx, x4, mask4, scale, impl):
        y, y32 = _fwd(impl)(x4, scale, False, mask4)
        ctx.save_for_backward(y32, mask4)
        ctx.scale, ctx.impl = scale, impl
        return y

    @staticmethod
    def backward(ctx, dy):
        y32, mask4 = ctx.saved_tensors
        # dy comes in y's dtype, x's: dx is cast to it once
        dx = _bwd(ctx.impl)(y32, dy.contiguous(), ctx.scale, mask4)
        return dx, None, None, None


def _as4d(x):
    """A (B, H, sq, sk) view of ``x``: leading 1s below rank 4, leading dims
    merged above it."""
    if x.ndim < 4:
        return x.reshape((1,) * (4 - x.ndim) + tuple(x.shape))
    return x.reshape(-1, *x.shape[-3:])


def scaled_softmax(x: torch.Tensor, scale: float = 1.0, *,
                   impl: Optional[str] = None) -> torch.Tensor:
    """softmax(scale*x) over the last dim (ref: scaled_softmax_cuda)."""
    impl = resolve_impl(impl, x)
    y = _ScaledSoftmax.apply(_as4d(x.contiguous()), float(scale), False, impl)
    return y.reshape(x.shape)


def scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                          scale: float = 1.0, *,
                          impl: Optional[str] = None) -> torch.Tensor:
    """softmax(scale*x masked) (ref: scaled_masked_softmax_cuda).

    x: (b, np, sq, sk); mask: (b, 1, sq, sk) or broadcastable, nonzero =
    masked out (filled with -10000 after the scale). The kernels read the
    mask through its strides: it is never expanded per head in memory."""
    impl = resolve_impl(impl, x)
    x4 = _as4d(x.contiguous())
    mask4 = _as4d(mask.expand(x.shape))
    y = _ScaledMaskedSoftmax.apply(x4, mask4, float(scale), impl)
    return y.reshape(x.shape)


def generic_scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                                  scale: float = 1.0, *,
                                  impl: Optional[str] = None) -> torch.Tensor:
    """Arbitrary-shape scale+mask+softmax
    (ref: generic_scaled_masked_softmax_cuda): the math of
    :func:`scaled_masked_softmax`, except that a row whose every position is
    masked comes out all zeros, where the non-generic variant gives 1/sk."""
    y = scaled_masked_softmax(x, mask, scale, impl=impl)
    # reduced on the unbroadcast mask: no per-head intermediate
    all_masked = (mask != 0).all(-1, keepdim=True)
    return torch.where(all_masked, torch.zeros((), dtype=y.dtype, device=y.device), y)


def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0, *,
                                       impl: Optional[str] = None) -> torch.Tensor:
    """Causal softmax(scale*x) (ref: scaled_upper_triang_masked_softmax_cuda).

    x: (attn_batches, sq, sk) with sq == sk (self-attention scores). The
    causal fill comes from the row index inside K11: no mask tensor."""
    impl = resolve_impl(impl, x)
    if x.ndim != 3:
        raise ValueError(f"causal softmax takes (attn_batches, sq, sk), got "
                         f"{tuple(x.shape)}")
    b, sq, sk = x.shape
    if sq != sk:
        raise ValueError(f"causal softmax expects square scores, got sq={sq} sk={sk}")
    y = _ScaledSoftmax.apply(x.contiguous()[:, None], float(scale), True, impl)
    return y.reshape(x.shape)
