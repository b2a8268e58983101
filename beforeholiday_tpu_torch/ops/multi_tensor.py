"""Multi-tensor ops over flat arenas — counterpart of
``beforeholiday_tpu/ops/multi_tensor.py`` (the reference's ``amp_C``).

Two kernels, both Triton, both streaming passes over a flat arena:

* K5, :func:`scale_kernel`, replaces ``beforeholiday_tpu/ops/_pallas_mt.py:179``
  ``_scale_kernel`` (launched through ``ew_call`` at ``:138``): ``y = x * s``
  in fp32 and a flag set when any input or output element is non-finite.
  The TPU ORs the flag across its sequential grid in SMEM; GPU programs run
  in no order, so here each program reduces its block to one bit and does an
  atomic max into a device int32 that the wrapper zeroes in-stream on every
  call. ``s`` is read from a device pointer, never passed as a host float,
  so the loss scale never leaves the card. Bound on an H100: bytes. The
  flagship's bf16 gradient arena (134,578,176 elements) to fp32 moves
  807 MB, 0.241 ms at 3.35 TB/s; the arithmetic is one multiply per element.
* K6, :func:`adam_kernel`, replaces ``_pallas_mt.py:273`` ``_adam_kernel``
  (launched from ``adam`` at ``:304``): Adam (mode 0, L2 decay folded into
  the gradient) or AdamW (mode 1, decoupled decay), fp32 math whatever the
  storage, ``grad_scale``, bias corrections, ``lr`` and ``found_inf`` read
  from device scalars. It updates p, m and v in place (the TPU's
  input/output aliasing, ``:332``) and writes the low-precision model copy
  in the same pass (``:295-301``), straight into the model arena the forward
  reads. On ``found_inf`` every load and store is masked off, so the step
  leaves p, m, v and the copy bitwise untouched and moves almost no bytes.
  Bound: bytes, 30 B per element with the fp32 unscaled gradient and a
  bf16 copy (g read 4, p/m/v read and written 24, copy written 2): 1.205 ms
  for the flagship's bf16 bucket.

Each has its plain PyTorch version beside it (:func:`scale_torch`,
:func:`adam_torch`), the CPU path and the kernels' yardstick on the card.
The list APIs (:func:`multi_tensor_scale`, :func:`multi_tensor_adam`) pack
their lists into a new arena first, as the JAX package does; a list holding
one arena already padded to ``TILE`` is used as it is.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.arena import flatten, is_arena, unflatten

# elements per Triton program of K5/K6
_BLOCK = 4096


def _device_scalar(x, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a 1-element device tensor: a tensor is cast in place on its
    device; a Python number becomes a fill (never a host-to-device copy,
    which would wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype).reshape(1)
    return torch.full((1,), x, dtype=dtype, device=like.device)


def _triton():
    from beforeholiday_tpu_torch._build import triton_cache_env

    triton_cache_env()
    import triton

    return triton


# ------------------------------------------------------------------ K5


def scale_torch(x: torch.Tensor, scale, out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: ``(x * scale in out_dtype, found_inf)``."""
    y = x.float() * (scale.float() if isinstance(scale, torch.Tensor) else scale)
    flag = ~torch.isfinite(x).all() | ~torch.isfinite(y).all()
    return y.to(out_dtype), flag


@functools.cache
def _scale_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _scale_flag(X, Y, S, FLAG, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.load(S)
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)
        # |v| < inf is false exactly for inf and NaN
        finite = (tl.abs(x) < float("inf")) & (tl.abs(y) < float("inf"))
        bad = tl.max(tl.where(mask & ~finite, 1, 0), axis=0)
        tl.atomic_max(FLAG, bad)

    return triton, _scale_flag


def scale_kernel(x: torch.Tensor, scale, out_dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on a 1-D contiguous CUDA tensor; returns ``(y, found_inf)``
    with ``found_inf`` a 0-d bool device tensor."""
    if not x.is_cuda or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"K5 takes a 1-D contiguous CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if not x.is_floating_point() or out_dtype not in (
            torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"K5 takes floating input and output, got "
                         f"{x.dtype} -> {out_dtype}")
    triton, kernel = _scale_triton()
    s = _device_scalar(scale, x)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    n = x.numel()
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](x, y, s, flag, n, BLOCK=_BLOCK,
                                          num_warps=8)
        scale_kernel.launches += 1
    return y, flag[0] != 0


scale_kernel.launches = 0


def multi_tensor_scale(src: Sequence[torch.Tensor], scale, *, out_dtype=None,
                       impl: Optional[str] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out[i] = src[i] * scale``; returns ``(outs, found_inf)``. ``found_inf``
    is set when any input or output element is non-finite (the amp unscale's
    overflow check). ``scale`` may be a device scalar tensor."""
    impl = resolve_impl(impl, src[0])
    if len(src) == 1 and is_arena(src[0]):
        flat, spec = src[0], None
    else:
        flat, spec = flatten(src)
    out_dtype = out_dtype or flat.dtype
    fn = scale_kernel if impl == "kernel" else scale_torch
    out, flag = fn(flat, scale, out_dtype)
    return ([out] if spec is None else unflatten(out, spec)), flag


# ------------------------------------------------------------------ K6


def _bias_corrections(bias_correction: bool, step, beta1: float, beta2: float):
    """``(1 - beta1**step, 1 - beta2**step)``; ``step`` may be a device
    tensor, and then so are the corrections (no host sync)."""
    if not bias_correction:
        return 1.0, 1.0
    if isinstance(step, torch.Tensor):
        s = step.float()
        return 1.0 - torch.pow(beta1, s), 1.0 - torch.pow(beta2, s)
    return 1.0 - beta1 ** float(step), 1.0 - beta2 ** float(step)


def _as_float(x):
    return x.float() if isinstance(x, torch.Tensor) else x


def adam_torch(g, p, m, v, *, lr, beta1, beta2, eps, bc1, bc2, weight_decay,
               adam_w_mode, grad_scale, found_inf, copy_out):
    """Plain PyTorch version of K6, in place on ``p``, ``m``, ``v`` (and
    ``copy_out`` when given), with the same fp32 arithmetic."""
    gf = g.float() * _as_float(grad_scale)
    pf, mf, vf = p.float(), m.float(), v.float()
    if not adam_w_mode:
        gf = gf + weight_decay * pf
    m_new = beta1 * mf + (1.0 - beta1) * gf
    v_new = beta2 * vf + (1.0 - beta2) * gf * gf
    update = (m_new / _as_float(bc1)) / (torch.sqrt(v_new / _as_float(bc2)) + eps)
    if adam_w_mode:
        update = update + weight_decay * pf
    p_new = pf - _as_float(lr) * update
    if found_inf is not None:
        skip = torch.as_tensor(found_inf, device=p.device) != 0
        p_new = torch.where(skip, pf, p_new)
        m_new = torch.where(skip, mf, m_new)
        v_new = torch.where(skip, vf, v_new)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    if copy_out is not None:
        copy_out.copy_(p_new)


@functools.cache
def _adam_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _adam(G, P, M, V, C, SCAL, FI, n, beta1, beta2, one_m_b1, one_m_b2,
              eps, decay, MODE: tl.constexpr, HAS_COPY: tl.constexpr,
              BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < n) & (tl.load(FI) == 0)
        bc1 = tl.load(SCAL)
        bc2 = tl.load(SCAL + 1)
        lr = tl.load(SCAL + 2)
        gs = tl.load(SCAL + 3)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32) * gs
        p = tl.load(P + offs, mask=mask, other=0.0)
        m = tl.load(M + offs, mask=mask, other=0.0)
        v = tl.load(V + offs, mask=mask, other=0.0)
        if MODE == 0:  # L2: decay folded into the gradient
            g = g + decay * p
        m_new = beta1 * m + one_m_b1 * g
        v_new = beta2 * v + one_m_b2 * g * g
        update = tl.div_rn(tl.div_rn(m_new, bc1),
                           tl.sqrt_rn(tl.div_rn(v_new, bc2)) + eps)
        if MODE == 1:  # AdamW: decoupled decay added to the update
            update = update + decay * p
        p_new = p - lr * update
        tl.store(P + offs, p_new, mask=mask)
        tl.store(M + offs, m_new, mask=mask)
        tl.store(V + offs, v_new, mask=mask)
        if HAS_COPY:
            tl.store(C + offs, p_new.to(C.dtype.element_ty), mask=mask)

    return triton, _adam


def adam_kernel(g, p, m, v, *, lr, beta1, beta2, eps, bc1, bc2, weight_decay,
                adam_w_mode, grad_scale, found_inf, copy_out):
    """Launch K6 on flat CUDA arenas: fp32 ``p``, ``m``, ``v`` updated in
    place, ``g`` fp32/bf16/fp16, optional ``copy_out`` of any float dtype."""
    arenas = (g, p, m, v) + (() if copy_out is None else (copy_out,))
    n = p.numel()
    for t in arenas:
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError("K6 takes 1-D contiguous CUDA arenas of one "
                             f"length on one device; got {tuple(t.shape)} "
                             f"on {t.device}")
    if not (p.dtype == m.dtype == v.dtype == torch.float32):
        raise ValueError(f"K6 updates fp32 p/m/v, got {p.dtype}/{m.dtype}/"
                         f"{v.dtype}")
    if not g.is_floating_point():
        raise ValueError(f"K6 takes a floating gradient, got {g.dtype}")
    triton, kernel = _adam_triton()
    scal = torch.cat([_device_scalar(x, p) for x in (bc1, bc2, lr, grad_scale)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](
            g, p, m, v, p if copy_out is None else copy_out, scal, fi, n,
            float(beta1), float(beta2), float(1.0 - beta1), float(1.0 - beta2),
            float(eps), float(weight_decay),
            MODE=1 if adam_w_mode else 0, HAS_COPY=copy_out is not None,
            BLOCK=_BLOCK, num_warps=8,
        )
        adam_kernel.launches += 1


adam_kernel.launches = 0


def adam_flat(gf, pf, mf, vf, *, lr, beta1: float = 0.9, beta2: float = 0.999,
              eps: float = 1e-8, step=1, adam_w_mode: bool = True,
              bias_correction: bool = True, weight_decay: float = 0.0,
              grad_scale=1.0, found_inf=None, model_copy_dtype=None,
              model_copy=None, impl: Optional[str] = None):
    """Fused Adam/AdamW over flat arenas, IN PLACE: ``pf``, ``mf`` and ``vf``
    are updated and returned (the JAX package returns new arrays; its TPU
    kernel aliases them the same way). ``step`` may be a device tensor.

    ``model_copy`` (a tensor of ``pf``'s length) receives the new params in
    its own dtype in the same pass; ``model_copy_dtype`` allocates one.
    Returns ``(p, m, v)`` or ``(p, m, v, model_copy)``."""
    impl = resolve_impl(impl, pf)
    if model_copy is None and model_copy_dtype is not None:
        model_copy = torch.empty(pf.shape, dtype=model_copy_dtype,
                                 device=pf.device)
    bc1, bc2 = _bias_corrections(bias_correction, step, beta1, beta2)
    fn = adam_kernel if impl == "kernel" else adam_torch
    fn(gf, pf, mf, vf, lr=lr, beta1=beta1, beta2=beta2, eps=eps, bc1=bc1,
       bc2=bc2, weight_decay=weight_decay, adam_w_mode=adam_w_mode,
       grad_scale=grad_scale, found_inf=found_inf, copy_out=model_copy)
    outs = (pf, mf, vf)
    return outs if model_copy is None else outs + (model_copy,)


def multi_tensor_adam(grads, params, exp_avgs, exp_avg_sqs, *, lr,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8, step=1, adam_w_mode: bool = True,
                      bias_correction: bool = True, weight_decay: float = 0.0,
                      grad_scale=1.0, found_inf=None,
                      impl: Optional[str] = None):
    """Fused Adam/AdamW over tensor lists; returns new ``(params, m, v)``
    lists (views of freshly packed arenas — the inputs are not modified).
    ``found_inf`` turns the whole update into the identity."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(exp_avgs)
    vf, _ = flatten(exp_avg_sqs)
    adam_flat(gf, pf, mf, vf, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              step=step, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, weight_decay=weight_decay,
              grad_scale=grad_scale, found_inf=found_inf, impl=impl)
    return unflatten(pf, spec), unflatten(mf, spec), unflatten(vf, spec)
