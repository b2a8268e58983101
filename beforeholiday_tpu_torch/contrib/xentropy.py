"""Fused label-smoothing softmax cross entropy on kernels K14 (forward) and
K15 (backward), both Triton — counterpart of
``beforeholiday_tpu/contrib/xentropy.py`` (Apex's
``SoftmaxCrossEntropyLoss``, ``apex/contrib/xentropy``).

Per row of (N, V) logits, with s the smoothing:

* ``lse = logsumexp(x)``, ``loss = (1 - s)(lse - x[label]) + s(lse - mean x)``,
  both fp32 whatever the logits' dtype;
* ``dx = dy * (exp(x - lse) - ((1 - s) onehot + s / V))``, in the logits'
  dtype;
* rows whose label is ``padding_idx`` get loss 0 and gradient 0: the wrapper
  zeroes their loss after the autograd Function, which zeroes dy there too,
  as JAX's ``where`` does.

K14 replaces ``_xent_fwd_kernel`` (``:48``, launched by ``_fwd_pallas`` at
``:84``), K15 ``_xent_bwd_kernel`` (``:64``, launched by ``_bwd_pallas`` at
``:111``). Bound on an H100: bytes. Neither does a matrix product: K14 is a
row reduction (max, sum of exp, sum of x and one gathered value), K15 one
elementwise pass with three per-row scalars. At the flagship's head (16,384
rows of 32,000 fp32 logits, 2.10 GB) K14 reads the logits once, 0.626 ms at
3.35 TB/s, and K15 reads them and writes dx once, 1.252 ms; about 0.13 ms
of exp at the card's rate for 524M elements stays under those.

Where the TPU kernels differ:
- The TPU holds blocks of 8 whole rows in VMEM. A 32,000-wide fp32 row is
  128 KB, more than a program should hold in registers, so one K14 program
  streams its row in chunks in a single pass (an online logsumexp): one
  running max for the row, taken once a chunk, and per lane a running sum
  of exp rescaled by one exp a chunk when the max grows, so each element
  costs one exp; plus a running sum of x for the smoothing term.
- Rows of an odd width (BERT's 30,522, GPT-2's 50,257) start off any
  16-byte boundary, and a load whose mask or start is not known to be
  aligned goes element by element. Both kernels therefore split each row
  into an aligned body, read in chunks that start on 16-element boundaries
  and end at the last one (16-byte vector loads), and two edges of fewer
  than 16 elements, read with a mask.
- x[label] is one scalar load, not a one-hot compare over V. A label
  outside [0, V) reads nothing and counts as 0, as the TPU kernel's compare
  finds no column; the plain versions do the same.
- K15 runs a 2-D grid (row, chunk of V), so 16,384 rows in 8 chunks fill the
  card's 132 SMs; each program reads its row's lse, dy and label once, and
  the first chunk's program also writes the row's two edges.
- The backward recomputes the softmax from the saved (logits, lse), as the
  TPU kernel does; nothing of size N x V is saved beyond the logits.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from beforeholiday_tpu_torch.ops._autocast import float_function
from beforeholiday_tpu_torch.ops._dispatch import resolve_impl

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_LABEL_DTYPES = (torch.int32, torch.int64)
# columns a program holds per chunk (at most; 16 a thread): K14 loops over a
# row's chunks, K15 runs one program per chunk. Chunks start on
# ALIGN-element boundaries, so that rows of any width load in 16-byte vectors
_K14_BLOCK = 2048
_K15_BLOCK = 4096
_ALIGN = 16


def _target_logit(x, labels):
    """x[row, label] in fp32, or 0 where the label is outside [0, V)."""
    V = x.shape[-1]
    inside = (labels >= 0) & (labels < V)
    tgt = x.gather(-1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(inside, tgt, 0.0)


def xent_fwd_torch(logits, labels, smoothing: float):
    """Plain PyTorch version of K14 (JAX's ``_fwd_jnp``, in its order): the
    CPU path and the kernel's yardstick. Returns ``(loss, lse)``, both fp32
    of shape (N,)."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    tgt = _target_logit(x, labels)
    loss = (1.0 - smoothing) * (lse - tgt) + smoothing * (lse - x.mean(dim=-1))
    return loss, lse


def xent_bwd_torch(logits, labels, lse, dy, smoothing: float):
    """Plain PyTorch version of K15 (JAX's ``_bwd_jnp``): ``dy * (exp(x -
    lse) - ((1 - s) onehot + s / V))`` in fp32, cast to the logits' dtype."""
    x = logits.float()
    V = x.shape[-1]
    onehot = (torch.arange(V, device=x.device) == labels[:, None]).float()
    soft = torch.exp(x - lse[:, None])
    dx = dy[:, None] * (soft - ((1.0 - smoothing) * onehot + smoothing / V))
    return dx.to(logits.dtype)


@functools.cache
def _xent_triton():
    # ``tl`` and the helper ``_grad_store`` are bound as module globals so
    # that the kernel bodies and their constexpr annotations resolve them the
    # way Triton looks names up
    global tl, _grad_store
    from beforeholiday_tpu_torch._build import triton_cache_env

    triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def _xent_fwd(X, LAB, LOSS, LSE, n_cols, keep, smoothing,
                  BLOCK: tl.constexpr, ALIGN: tl.constexpr):
        row = tl.program_id(0)
        lo = row.to(tl.int64) * n_cols
        hi = lo + n_cols
        # the row's ALIGN-aligned body, loaded in vectors, and its two
        # unaligned edges [lo, e1) and [s2, hi), under ALIGN elements each
        body_lo = (lo + ALIGN - 1) // ALIGN * ALIGN
        body_hi = hi // ALIGN * ALIGN
        e1 = tl.minimum(body_lo, hi)
        s2 = tl.maximum(body_hi, e1)
        edge = tl.arange(0, ALIGN)
        head_ok = lo + edge < e1
        tail_ok = s2 + edge < hi
        xh = tl.load(X + lo + edge, mask=head_ok, other=float("-inf")).to(tl.float32)
        xt = tl.load(X + s2 + edge, mask=tail_ok, other=float("-inf")).to(tl.float32)
        # one running max for the row, seeded by the edges; the sums of exp
        # per lane, rescaled by one exp a chunk when the max grows
        m = tl.maximum(tl.max(xh, axis=0), tl.max(xt, axis=0))
        acc = tl.zeros([BLOCK], tl.float32)
        sx = tl.zeros([BLOCK], tl.float32)
        n_chunks = ((body_hi - body_lo + BLOCK - 1) // BLOCK).to(tl.int32)
        for c in range(0, n_chunks):
            offs = body_lo + c * BLOCK + tl.arange(0, BLOCK)
            offs = tl.max_contiguous(tl.multiple_of(offs, ALIGN), BLOCK)
            valid = offs < body_hi
            x = tl.load(X + offs, mask=valid, other=float("-inf")).to(tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=0))
            # all -inf so far: rescale against 0, so that exp gives 0, not NaN
            ref = tl.where(m_new == float("-inf"), 0.0, m_new)
            acc = acc * tl.exp(m - ref) + tl.exp(x - ref)
            sx += tl.where(valid, x, 0.0)
            m = m_new
        ref = tl.where(m == float("-inf"), 0.0, m)
        total = (tl.sum(acc, axis=0) + tl.sum(tl.exp(xh - ref), axis=0)
                 + tl.sum(tl.exp(xt - ref), axis=0))
        lse = ref + tl.log(total)
        sum_x = (tl.sum(sx, axis=0) + tl.sum(tl.where(head_ok, xh, 0.0), axis=0)
                 + tl.sum(tl.where(tail_ok, xt, 0.0), axis=0))
        lab = tl.load(LAB + row)
        inside = (lab >= 0) & (lab < n_cols)
        tgt = tl.load(X + lo + lab, mask=inside, other=0.0).to(tl.float32)
        tl.store(LOSS + row, keep * (lse - tgt) + smoothing * (lse - sum_x / n_cols))
        tl.store(LSE + row, lse)

    @triton.jit
    def _grad_store(X, DX, offs, valid, lo, lse, dy, lab, keep, spread):
        x = tl.load(X + offs, mask=valid, other=0.0).to(tl.float32)
        onehot = tl.where(offs - lo == lab, 1.0, 0.0)
        dx = dy * (tl.exp(x - lse) - (keep * onehot + spread))
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=valid)

    @triton.jit
    def _xent_bwd(X, LAB, LSE, DY, DX, n_cols, keep, spread,
                  BLOCK: tl.constexpr, ALIGN: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        lo = row.to(tl.int64) * n_cols
        hi = lo + n_cols
        body_lo = (lo + ALIGN - 1) // ALIGN * ALIGN
        body_hi = hi // ALIGN * ALIGN
        lse = tl.load(LSE + row)
        dy = tl.load(DY + row)
        lab = tl.load(LAB + row)
        start = body_lo + chunk * BLOCK
        if start < body_hi:
            offs = start + tl.arange(0, BLOCK)
            offs = tl.max_contiguous(tl.multiple_of(offs, ALIGN), BLOCK)
            _grad_store(X, DX, offs, offs < body_hi, lo, lse, dy, lab, keep, spread)
        if chunk == 0:  # the unaligned edges, as in K14
            e1 = tl.minimum(body_lo, hi)
            s2 = tl.maximum(body_hi, e1)
            edge = tl.arange(0, ALIGN)
            _grad_store(X, DX, lo + edge, lo + edge < e1, lo, lse, dy, lab,
                        keep, spread)
            _grad_store(X, DX, s2 + edge, s2 + edge < hi, lo, lse, dy, lab,
                        keep, spread)

    return triton, _xent_fwd, _xent_bwd


def _launch_shape(triton, V, most):
    """``(BLOCK, num_warps)`` for rows of V columns, BLOCK at most ``most``."""
    block = min(most, max(_ALIGN, triton.next_power_of_2(V)))
    return block, max(4, block // 512)


def _check(name, logits, labels, *rows):
    """The checks K14 and K15 share: a contiguous (N, V) CUDA tensor of a
    float type they take, (N,) int32/int64 labels and fp32 per-row vectors
    on its device."""
    if logits.ndim != 2 or not logits.is_cuda:
        raise ValueError(f"{name} takes 2-D CUDA logits (N, V), got "
                         f"{tuple(logits.shape)} on {logits.device}")
    if logits.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} does not take dtype {logits.dtype}")
    N = logits.shape[0]
    if labels.dtype not in _LABEL_DTYPES:
        raise ValueError(f"{name} takes int32 or int64 labels, got {labels.dtype}")
    for t in (labels, *rows):
        if t.shape != (N,) or t.device != logits.device:
            raise ValueError(f"{name} takes per-row vectors ({N},) on "
                             f"{logits.device}, got {tuple(t.shape)} on {t.device}")
    for t in rows:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes fp32 lse and dy, got {t.dtype}")
    if not all(t.is_contiguous() for t in (logits, labels, *rows)):
        raise ValueError(f"{name} takes contiguous operands")


def xent_fwd_kernel(logits, labels, smoothing: float):
    """Launch K14 on CUDA tensors; the plain version's contract. Checks
    device, dtype, shape and layout and raises on anything the kernel does
    not take."""
    _check("K14", logits, labels)
    N, V = logits.shape
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    if N and V:
        triton, kernel, _ = _xent_triton()
        block, warps = _launch_shape(triton, V, _K14_BLOCK)
        # 1 - s rounded from the double, as JAX folds the Python constant
        kernel[(N,)](logits, labels, loss, lse, V, 1.0 - smoothing,
                     float(smoothing), BLOCK=block, ALIGN=_ALIGN, num_warps=warps)
        xent_fwd_kernel.launches += 1
    return loss, lse


xent_fwd_kernel.launches = 0


def xent_bwd_kernel(logits, labels, lse, dy, smoothing: float):
    """Launch K15 on CUDA tensors; the plain version's contract. Checks
    device, dtype, shape and layout and raises on anything the kernel does
    not take."""
    _check("K15", logits, labels, lse, dy)
    N, V = logits.shape
    dx = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
    if N and V:
        triton, _, kernel = _xent_triton()
        block, warps = _launch_shape(triton, V, _K15_BLOCK)
        kernel[(N, triton.cdiv(V, block))](
            logits, labels, lse, dy, dx, V, 1.0 - smoothing, smoothing / V,
            BLOCK=block, ALIGN=_ALIGN, num_warps=warps)
        xent_bwd_kernel.launches += 1
    return dx


xent_bwd_kernel.launches = 0


class _SoftmaxXentropy(torch.autograd.Function):
    """JAX's ``_xent`` and its ``custom_vjp``: the forward returns the fp32
    per-row loss and saves ``(logits, labels, lse)``, not the softmax; the
    backward returns dx in the logits' dtype and nothing for the labels."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, impl):
        fwd = xent_fwd_kernel if impl == "kernel" else xent_fwd_torch
        loss, lse = fwd(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.impl = smoothing, impl
        return loss

    @staticmethod
    def backward(ctx, dy):
        logits, labels, lse = ctx.saved_tensors
        bwd = xent_bwd_kernel if ctx.impl == "kernel" else xent_bwd_torch
        dx = bwd(logits, labels, lse, dy.contiguous(), ctx.smoothing)
        return dx, None, None, None


@float_function
def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0, padding_idx: int = 0,
                               half_to_float: bool = False, *,
                               impl: Optional[str] = None) -> torch.Tensor:
    """Per-row fused softmax cross entropy with label smoothing
    (ref: ``SoftmaxCrossEntropyLoss.apply``, softmax_xentropy.py:6-28).

    logits (N, V); labels (N,) of any integer dtype. Rows whose label is
    ``padding_idx`` give zero loss and zero gradient. Returns (N,) losses in
    the logits' dtype, or fp32 when ``half_to_float``. On CUDA tensors it
    runs K14/K15, on CPU tensors their plain versions."""
    if logits.ndim != 2 or labels.ndim != 1 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"expected logits (N, V) and labels (N,), got "
                         f"{tuple(logits.shape)} / {tuple(labels.shape)}")
    impl = resolve_impl(impl, logits, op="softmax_cross_entropy")
    labels = labels.long().contiguous()
    not_pad = labels != padding_idx
    loss = _SoftmaxXentropy.apply(logits.contiguous(), labels, float(smoothing),
                                  impl)
    # zeroing the padded rows' loss also zeroes their dy: the reference's two
    # masked_fill_ calls in one
    loss = torch.where(not_pad, loss, 0.0)
    return loss.to(torch.float32 if half_to_float else logits.dtype)
