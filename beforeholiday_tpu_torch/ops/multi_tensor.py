"""Multi-tensor ops over flat arenas — counterpart of
``beforeholiday_tpu/ops/multi_tensor.py`` (the reference's ``amp_C``).

Nine kernels, all Triton, all streaming passes over flat arenas:

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
* K9, :func:`l2norm_sq_kernel`, replaces ``_pallas_mt.py:238`` ``l2norm_sq``
  (body ``_l2norm_kernel`` ``:228``): the sum of squares of an arena and a
  non-finite flag. The TPU accumulates into one SMEM scalar across its
  sequential grid; here a fixed number of programs (set by the length
  alone) each walk a strided set of blocks and write one fp32 partial and
  one flag, and a second one-program launch sums the partials in a fixed
  order. No float atomics, so the result is bitwise the same run to run,
  and it stays on the card (no ``.item()``). Bound: bytes, 4 B per fp32
  element: 0.160 ms for BERT-Large's 134,283,264-element gradient arena.
* K7, :func:`lamb_stage1_kernel`, replaces ``_pallas_mt.py:455``
  ``_lamb1_kernel`` (launched from ``lamb_stage1`` at ``:477``): LAMB's
  Adam-style update ``u`` from the clipped gradient, with new moments
  written in place (the TPU aliases them, ``:502``) and ``u`` into a fresh
  arena. ``bc1``, ``bc2`` and the clip divisor are device scalars. On
  ``found_inf`` it writes ``u = 0`` and loads and stores no moment, the
  select of ``:472-474``. Bound: bytes, 28 B per element (g, p, m, v read;
  u, m, v written): 1.12 ms for the BERT-Large arena.
* K8, :func:`scaled_update_kernel`, replaces ``_pallas_mt.py:558``
  ``_scaled_update_kernel`` (launched from ``apply_scaled_update`` at
  ``:567``): ``p -= ratio[tensor] * u`` in place with the model copy in
  the same pass, held on ``found_inf``. The TPU reads a per-element
  coefficient arena that ``_segment_coef`` materializes; K8 instead reads
  the per-tensor ratio vector and finds each element's tensor from the
  spec's offsets (a per-block table of the first tensor and the tensor
  starts inside the block), which saves the coefficient arena's 8 B per
  element. Bound: bytes, 14 B per element with a bf16 copy: 0.56 ms for
  the BERT-Large arena. On a ZeRO shard (``shard=``, an ``ArenaShard``)
  only the table changes: built from the shard's base, it keeps global
  tensor ids, and positions past the arena's tensors take the padding's
  ratio 0.
* K10, :func:`sgd_kernel`, replaces ``_pallas_mt.py:376`` ``_sgd_kernel``
  (launched from ``sgd`` at ``:415``): SGD with the gradient scale, weight
  decay before or after momentum, the momentum buffer seeded with the
  gradient on the first step (``first_run``, a device flag read by the
  kernel, so ``step == 0`` is never read back), dampening and Nesterov. It
  updates p and m in place (the TPU's aliasing, ``:443``) and writes the
  model copy in the same pass (``:409-412``). p may be fp32, bf16 or fp16
  with fp32 momentum, the math fp32 and p stored back in its own dtype
  (``:406-411``; amp O3's list path keeps fp16 params with no masters). On
  ``found_inf`` every load and store is masked off. Bound: bytes, 22 B per
  element with the fp32 gradient and a bf16 copy (g read 4, p and m read
  and written 16, copy 2): 0.168 ms for ResNet-50's bf16 arena (25,526,272
  elements); 20 B without a copy (0.153 ms for the O0 list path's
  25,559,040); 16 B with fp16 p (0.122 ms for O3's 25,559,040).
* K6 and K10 views mode, :func:`adam_views_kernel` and
  :func:`sgd_views_kernel`: the optimizers' view path (``_step_views``,
  the pack-free tree-gradient step behind ``step_in_backward``). The
  parameters, moments and model copy are still the arenas; only the
  gradients are read where they lie, through a device int64 table of
  (gradient pointer, element count, arena offset) per leaf and a block ->
  (leaf, chunk) map, as Apex's ``multi_tensor_apply`` does: one launch an
  arena, the same per-element arithmetic as the arena launch (so bitwise
  its result on the same values), and no gradient arena packed. The map is
  built once per tuple of leaf sizes; the table once per tuple of gradient
  addresses, so a step whose gradients land where an earlier step's did
  reuses it, and one whose gradients land elsewhere pays one pinned,
  non-blocking copy of three int64 a leaf (tree gradients from autograd
  land at new addresses on most steps). The arena's tail padding, which no
  leaf covers, is left as it is. Bound: bytes, as the arena launch's less
  the padding; the gradient loads go one element at a time (Triton cannot
  prove a table pointer's alignment).

* K16, :func:`axpby_kernel`, replaces ``_pallas_mt.py:195`` ``_axpby_kernel``
  (launched from ``axpby`` at ``:209``): ``out = a * x + b * y`` in fp32,
  stored in any float dtype, with K5's non-finite flag over x, y or both
  (``arg_to_check``). ``a`` and ``b`` are read from device memory. Bound:
  bytes, 12 B per element for fp32 in and out: 0.0914 ms for ResNet-50's
  bf16-parameter arena (25,526,272 elements) of unscaled fp32 gradients.
* K17, :func:`adagrad_kernel`, replaces ``_pallas_mt.py:343``
  ``_adagrad_kernel`` (launched from ``adagrad`` at ``:358``): ``h += g*g``,
  ``p -= lr * g / (sqrt(h) + eps)``, the decay folded into g (mode 0) or
  added to the update (mode 1), p and h in place and every load and store
  masked off on ``found_inf``. It contracts no multiply-add: on the first
  step ``g / (sqrt(g*g) + eps)`` is a sign, and where the decayed gradient
  cancels to near eps one ulp of it moves p visibly, so K17 rounds each
  operation as :func:`adagrad_torch` does. Bound: bytes, 20 B per element
  (g read, p and h read and written): 0.153 ms for ResNet-50's fp32 master
  arena on the list path (25,559,040 elements).
* K18, :func:`novograd_kernel`, replaces ``_pallas_mt.py:514``
  ``_novograd_kernel`` (launched from ``novograd_ew`` at ``:536``):
  NovoGrad's elementwise phase, in place on p and m, masked off on
  ``found_inf``. The TPU kernel reads a per-element denominator arena that
  ``_segment_coef`` spreads from the per-tensor values; K18 reads the
  per-tensor values through K8's per-block segment table instead, which
  saves that arena's write and read (8 B per element). The padding's
  denominator is 1, so the padding of p and m stays 0 (``_segment_coef``'s
  0 there would make it 0/0). Bound: bytes, 20 B per element: 0.153 ms for
  ResNet-50's master arena.

Each has its plain PyTorch version beside it (:func:`scale_torch`,
:func:`adam_torch`, :func:`adam_views_torch`, :func:`sgd_views_torch`, :func:`l2norm_sq_torch`, :func:`lamb_stage1_torch`,
:func:`scaled_update_torch`, :func:`sgd_torch`, :func:`axpby_torch`,
:func:`adagrad_torch`, :func:`novograd_torch`), the CPU path and the
kernels' yardstick on the card. The list APIs (:func:`multi_tensor_scale`,
:func:`multi_tensor_adam`, :func:`multi_tensor_l2norm`,
:func:`multi_tensor_lamb`, :func:`multi_tensor_sgd`,
:func:`multi_tensor_axpby`, :func:`multi_tensor_adagrad`,
:func:`multi_tensor_novograd`, :func:`multi_tensor_lars`) pack their lists
into a new arena first, as the JAX package does; a list holding one arena
already padded to ``TILE`` is used as it is by the scale, axpby and L2
norm. The per-tensor sums of squares that the LAMB, LARS and NovoGrad
terms need (:func:`per_tensor_sumsq`) are plain PyTorch, as the JAX
package computes them in jnp outside any kernel; LARS has no kernel of its
own (its trust ratios in plain PyTorch, then K10).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.arena import (
    ArenaShard,
    ArenaSpec,
    flatten,
    is_arena,
    unflatten,
)

# elements per Triton program of K5-K8 and K10, and per block of K9's walk
_BLOCK = 4096
_HALF_OR_FP32 = (torch.float32, torch.bfloat16, torch.float16)


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
    impl = resolve_impl(impl, src[0], op="multi_tensor_scale")
    if len(src) == 1 and is_arena(src[0]):
        flat, spec = src[0], None
    else:
        flat, spec = flatten(src)
    out_dtype = out_dtype or flat.dtype
    fn = scale_kernel if impl == "kernel" else scale_torch
    out, flag = fn(flat, scale, out_dtype)
    return ([out] if spec is None else unflatten(out, spec)), flag


# ----------------------------------------------------------------- K16


def axpby_torch(x: torch.Tensor, y: torch.Tensor, a, b, out_dtype,
                arg_to_check: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K16: ``(a * x + b * y in out_dtype,
    found_inf)`` in fp32, the flag set when a checked input (-1 both, 0 x,
    1 y) holds a non-finite element."""
    xf, yf = x.float(), y.float()
    out = _as_float(a) * xf + _as_float(b) * yf
    checked = {-1: (xf, yf), 0: (xf,), 1: (yf,)}[arg_to_check]
    flag = torch.stack([~torch.isfinite(t).all() for t in checked]).any()
    return out.to(out_dtype), flag


@functools.cache
def _axpby_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _axpby_flag(X, Y, OUT, SCAL, FLAG, n, CHECK: tl.constexpr,
                    BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        y = tl.load(Y + offs, mask=mask, other=0.0).to(tl.float32)
        out = tl.load(SCAL) * x + tl.load(SCAL + 1) * y
        tl.store(OUT + offs, out.to(OUT.dtype.element_ty), mask=mask)
        # |v| < inf is false exactly for inf and NaN
        if CHECK == 0:
            finite = tl.abs(x) < float("inf")
        elif CHECK == 1:
            finite = tl.abs(y) < float("inf")
        else:
            finite = (tl.abs(x) < float("inf")) & (tl.abs(y) < float("inf"))
        bad = tl.max(tl.where(mask & ~finite, 1, 0), axis=0)
        tl.atomic_max(FLAG, bad)

    return triton, _axpby_flag


def axpby_kernel(x: torch.Tensor, y: torch.Tensor, a, b, out_dtype,
                 arg_to_check: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K16 on two 1-D contiguous CUDA tensors of one length; returns
    ``(out, found_inf)`` with ``found_inf`` a 0-d bool device tensor. ``a``
    and ``b`` may be numbers or device scalars."""
    for t in (x, y):
        if not t.is_cuda or t.device != x.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != x.numel():
            raise ValueError("K16 takes 1-D contiguous CUDA tensors of one "
                             f"length on one device; got {tuple(t.shape)} "
                             f"on {t.device}")
        if not t.is_floating_point():
            raise ValueError(f"K16 takes floating inputs, got {t.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"K16 writes fp32, bf16 or fp16, got {out_dtype}")
    if arg_to_check not in (-1, 0, 1):
        raise ValueError(f"arg_to_check must be -1, 0 or 1, got {arg_to_check}")
    triton, kernel = _axpby_triton()
    scal = torch.cat([_device_scalar(a, x), _device_scalar(b, x)])
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    n = x.numel()
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](x, y, out, scal, flag, n,
                                          CHECK=arg_to_check, BLOCK=_BLOCK,
                                          num_warps=8)
        axpby_kernel.launches += 1
    return out, flag[0] != 0


axpby_kernel.launches = 0


def multi_tensor_axpby(x: Sequence[torch.Tensor], y: Sequence[torch.Tensor],
                       a, b, *, out_dtype=None, arg_to_check: int = -1,
                       impl: Optional[str] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out[i] = a * x[i] + b * y[i]`` in fp32, stored in ``out_dtype``
    (``x``'s by default); returns ``(outs, found_inf)``, the flag set when a
    non-finite element is found in x and y (``arg_to_check`` -1), x alone
    (0) or y alone (1). Two lists each holding one arena already padded to
    ``TILE`` (a ``PackedParams`` gradient arena) are used as they are."""
    impl = resolve_impl(impl, x[0], op="multi_tensor_axpby")
    if (len(x) == len(y) == 1 and is_arena(x[0]) and is_arena(y[0])
            and x[0].numel() == y[0].numel()):
        xf, yf, spec = x[0], y[0], None
    else:
        xf, spec = flatten(x)
        yf, _ = flatten(y)
    out_dtype = out_dtype or xf.dtype
    fn = axpby_kernel if impl == "kernel" else axpby_torch
    out, flag = fn(xf, yf, a, b, out_dtype, arg_to_check)
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
    impl = resolve_impl(impl, pf, op="adam")
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


# ------------------------------------------------------ K6/K10 views mode


def _check_views(name, gleaves, spec: ArenaSpec, arenas):
    if len(gleaves) != spec.num_tensors:
        raise ValueError(f"{name}: {len(gleaves)} gradient leaves for a spec of "
                         f"{spec.num_tensors} tensors")
    for g, shape in zip(gleaves, spec.shapes):
        if g.numel() != math.prod(shape):
            raise ValueError(f"{name}: a gradient leaf of {g.numel()} elements "
                             f"where the spec has {tuple(shape)}")
    for t in arenas:
        if t is not None and (t.ndim != 1 or t.numel() != spec.padded_total):
            raise ValueError(f"{name}: arenas must be 1-D of the spec's "
                             f"{spec.padded_total} elements, got {tuple(t.shape)}")


def _to_device(host: torch.Tensor, device: torch.device):
    """``(device copy, host source)``: a pinned, non-blocking copy to a
    card (the host never waits), the tensor itself on the CPU."""
    if device.type == "cpu":
        return host, host
    host = host.pin_memory()
    return host.to(device, non_blocking=True), host


@functools.lru_cache(maxsize=64)
def _views_block_map(counts: Tuple[int, ...], device: torch.device):
    """The launch's block -> (leaf, chunk) map, int32 pairs, on ``device``
    (with its pinned source): built once per tuple of leaf sizes."""
    pairs = [(i, c) for i, n in enumerate(counts) for c in range(-(-n // _BLOCK))]
    return _to_device(torch.tensor(pairs, dtype=torch.int32).reshape(-1), device)


# (gradient addresses, sizes, offsets, device) -> the device table and its
# pinned source, most recent last
_VIEWS_TABLES: "dict" = {}
_VIEWS_TABLES_MAX = 8
views_tables_built = [0]


def _views_table(gleaves, spec: ArenaSpec, device: torch.device) -> torch.Tensor:
    """The int64 (gradient pointer, element count, arena offset) table of
    the leaves, on ``device``. Built (one pinned, non-blocking copy) the
    first time a tuple of addresses is seen; a step whose gradients land
    where the last ones did reuses it."""
    counts = tuple(g.numel() for g in gleaves)
    key = (tuple(g.data_ptr() for g in gleaves), counts, spec.offsets, device)
    hit = _VIEWS_TABLES.pop(key, None)
    if hit is None:
        rows = [(ptr, n, off) for ptr, n, off in zip(key[0], counts, spec.offsets)]
        hit = _to_device(torch.tensor(rows, dtype=torch.int64).reshape(-1), device)
        views_tables_built[0] += 1
        while len(_VIEWS_TABLES) >= _VIEWS_TABLES_MAX:
            _VIEWS_TABLES.pop(next(iter(_VIEWS_TABLES)))
    _VIEWS_TABLES[key] = hit
    return hit[0]


def _views_launch_args(name, gleaves, spec, p):
    """Validate the gradient leaves of a views-mode launch on ``p``'s
    device; ``(table, block map, number of blocks)``."""
    for g in gleaves:
        if not g.is_cuda or g.device != p.device or not g.is_contiguous():
            raise ValueError(f"{name} reads contiguous CUDA gradient leaves on "
                             f"the arena's device; got {tuple(g.shape)} on "
                             f"{g.device} (contiguous {g.is_contiguous()})")
        if g.dtype != gleaves[0].dtype or not g.is_floating_point():
            raise ValueError(f"{name} takes one floating gradient dtype a "
                             f"launch, got {g.dtype} and {gleaves[0].dtype}")
    counts = tuple(g.numel() for g in gleaves)
    bmap = _views_block_map(counts, p.device)[0]
    return _views_table(gleaves, spec, p.device), bmap, bmap.numel() // 2


def adam_views_torch(gleaves, p, m, v, spec: ArenaSpec, *, copy_out, **hyper):
    """Plain PyTorch version of K6's views mode: :func:`adam_torch` leaf by
    leaf on the arenas' views, in place."""
    for g, off, shape in zip(gleaves, spec.offsets, spec.shapes):
        n = math.prod(shape)
        adam_torch(g.reshape(-1), p[off: off + n], m[off: off + n],
                   v[off: off + n], copy_out=(None if copy_out is None
                                              else copy_out[off: off + n]),
                   **hyper)


@functools.cache
def _adam_views_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _adam_views(TAB, BMAP, GT, P, M, V, C, SCAL, FI, beta1, beta2, one_m_b1,
                    one_m_b2, eps, decay, MODE: tl.constexpr,
                    HAS_COPY: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(0)
        leaf = tl.load(BMAP + 2 * b).to(tl.int64)
        chunk = tl.load(BMAP + 2 * b + 1).to(tl.int64)
        g_ptr = tl.load(TAB + 3 * leaf).to(tl.pointer_type(GT.dtype.element_ty))
        count = tl.load(TAB + 3 * leaf + 1)
        base = tl.load(TAB + 3 * leaf + 2)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < count) & (tl.load(FI) == 0)
        bc1 = tl.load(SCAL)
        bc2 = tl.load(SCAL + 1)
        lr = tl.load(SCAL + 2)
        gs = tl.load(SCAL + 3)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * gs
        p = tl.load(P + base + offs, mask=mask, other=0.0)
        m = tl.load(M + base + offs, mask=mask, other=0.0)
        v = tl.load(V + base + offs, mask=mask, other=0.0)
        if MODE == 0:
            g = g + decay * p
        m_new = beta1 * m + one_m_b1 * g
        v_new = beta2 * v + one_m_b2 * g * g
        update = tl.div_rn(tl.div_rn(m_new, bc1),
                           tl.sqrt_rn(tl.div_rn(v_new, bc2)) + eps)
        if MODE == 1:
            update = update + decay * p
        p_new = p - lr * update
        tl.store(P + base + offs, p_new, mask=mask)
        tl.store(M + base + offs, m_new, mask=mask)
        tl.store(V + base + offs, v_new, mask=mask)
        if HAS_COPY:
            tl.store(C + base + offs, p_new.to(C.dtype.element_ty), mask=mask)

    return triton, _adam_views


def adam_views_kernel(gleaves, p, m, v, spec: ArenaSpec, *, lr, beta1, beta2, eps,
                      bc1, bc2, weight_decay, adam_w_mode, grad_scale, found_inf,
                      copy_out):
    """Launch K6's views mode: fp32 arenas ``p``, ``m``, ``v`` of ``spec``
    updated in place from the gradient leaves where they lie (one floating
    dtype), optional ``copy_out`` arena of any float dtype. One launch."""
    _check_views("K6 views", gleaves, spec, (p, m, v, copy_out))
    for t in (p, m, v) + (() if copy_out is None else (copy_out,)):
        if not t.is_cuda or t.device != p.device or not t.is_contiguous():
            raise ValueError("K6 views updates contiguous CUDA arenas on one "
                             f"device; got {t.device}")
    if not (p.dtype == m.dtype == v.dtype == torch.float32):
        raise ValueError(f"K6 updates fp32 p/m/v, got {p.dtype}/{m.dtype}/{v.dtype}")
    table, bmap, blocks = _views_launch_args("K6 views", gleaves, spec, p)
    triton, kernel = _adam_views_triton()
    scal = torch.cat([_device_scalar(x, p) for x in (bc1, bc2, lr, grad_scale)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    if blocks:
        kernel[(blocks,)](
            table, bmap, gleaves[0], p, m, v, p if copy_out is None else copy_out,
            scal, fi, float(beta1), float(beta2), float(1.0 - beta1),
            float(1.0 - beta2), float(eps), float(weight_decay),
            MODE=1 if adam_w_mode else 0, HAS_COPY=copy_out is not None,
            BLOCK=_BLOCK, num_warps=8)
        adam_views_kernel.launches += 1


adam_views_kernel.launches = 0


def adam_views(gleaves, pf, mf, vf, spec: ArenaSpec, *, lr, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8, step=1,
               adam_w_mode: bool = True, bias_correction: bool = True,
               weight_decay: float = 0.0, grad_scale=1.0, found_inf=None,
               model_copy=None, impl: Optional[str] = None):
    """:func:`adam_flat` with the gradients as a list of leaves laid out by
    ``spec`` (K6's views mode on CUDA arenas, the plain per-leaf version on
    CPU ones), IN PLACE on the arenas; returns ``(p, m, v)`` or ``(p, m,
    v, model_copy)``."""
    impl = resolve_impl(impl, pf, op="adam_views")
    bc1, bc2 = _bias_corrections(bias_correction, step, beta1, beta2)
    fn = adam_views_kernel if impl == "kernel" else adam_views_torch
    fn(list(gleaves), pf, mf, vf, spec, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
       bc1=bc1, bc2=bc2, weight_decay=weight_decay, adam_w_mode=adam_w_mode,
       grad_scale=grad_scale, found_inf=found_inf, copy_out=model_copy)
    outs = (pf, mf, vf)
    return outs if model_copy is None else outs + (model_copy,)


# ----------------------------------------------------------------- K17


def adagrad_torch(g, p, h, *, lr, eps, weight_decay, mode, found_inf):
    """Plain PyTorch version of K17, in place on ``p`` and ``h``, with the
    same fp32 arithmetic: ``h += g*g``, ``p -= lr * g / (sqrt(h) + eps)``,
    the decay folded into g (mode 0) or added to the update (mode 1)."""
    gf, pf, hf = g.float(), p.float(), h.float()
    if mode == 0:
        gf = gf + weight_decay * pf
        h_new = hf + gf * gf
        p_new = pf - _as_float(lr) * (gf / (torch.sqrt(h_new) + eps))
    else:
        h_new = hf + gf * gf
        p_new = pf - _as_float(lr) * (gf / (torch.sqrt(h_new) + eps)
                                      + weight_decay * pf)
    if found_inf is not None:
        skip = torch.as_tensor(found_inf, device=p.device) != 0
        p_new = torch.where(skip, pf, p_new)
        h_new = torch.where(skip, hf, h_new)
    p.copy_(p_new)
    h.copy_(h_new)


@functools.cache
def _adagrad_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _adagrad(G, P, H, LR, FI, n, eps, decay, MODE: tl.constexpr,
                 BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < n) & (tl.load(FI) == 0)
        lr = tl.load(LR)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(P + offs, mask=mask, other=0.0)
        h = tl.load(H + offs, mask=mask, other=0.0)
        if MODE == 0:  # L2: decay folded into the gradient
            g = g + decay * p
        h_new = h + g * g
        update = tl.div_rn(g, tl.sqrt_rn(h_new) + eps)
        if MODE == 1:  # decoupled decay added to the update
            update = update + decay * p
        tl.store(P + offs, p - lr * update, mask=mask)
        tl.store(H + offs, h_new, mask=mask)

    return triton, _adagrad


def adagrad_kernel(g, p, h, *, lr, eps, weight_decay, mode, found_inf):
    """Launch K17 on flat CUDA arenas: fp32 ``p`` and ``h`` updated in
    place, ``g`` fp32/bf16/fp16; ``lr`` a number or a device scalar,
    ``found_inf`` read from device memory by the kernel."""
    n = p.numel()
    for t in (g, p, h):
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError("K17 takes 1-D contiguous CUDA arenas of one "
                             f"length on one device; got {tuple(t.shape)} "
                             f"on {t.device}")
    if not (p.dtype == h.dtype == torch.float32):
        raise ValueError(f"K17 updates fp32 p/h, got {p.dtype}/{h.dtype}")
    if not g.is_floating_point():
        raise ValueError(f"K17 takes a floating gradient, got {g.dtype}")
    triton, kernel = _adagrad_triton()
    lr_t = _device_scalar(lr, p)
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    if n:
        # no multiply-add contraction: where g + decay * p cancels to near
        # eps, g / (sqrt(h) + eps) turns one ulp of it into a visible step,
        # so K17 rounds each operation as the plain version does
        kernel[(triton.cdiv(n, _BLOCK),)](
            g, p, h, lr_t, fi, n, float(eps), float(weight_decay),
            MODE=mode, BLOCK=_BLOCK, num_warps=8, enable_fp_fusion=False)
        adagrad_kernel.launches += 1


adagrad_kernel.launches = 0


def multi_tensor_adagrad(grads, params, state_sums, *, lr, eps: float = 1e-10,
                         weight_decay: float = 0.0, mode: int = 0,
                         found_inf=None, impl: Optional[str] = None):
    """Fused Adagrad over tensor lists; returns new ``(params, state_sums)``
    lists (views of freshly packed arenas — the inputs are not modified).
    ``found_inf`` turns the whole update into the identity."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    hf, _ = flatten(state_sums)
    impl = resolve_impl(impl, pf, op="adagrad")
    fn = adagrad_kernel if impl == "kernel" else adagrad_torch
    fn(gf, pf, hf, lr=lr, eps=eps, weight_decay=weight_decay, mode=mode,
       found_inf=found_inf)
    return unflatten(pf, spec), unflatten(hf, spec)


# ------------------------------------------------------------------ K9


# K9's first stage runs at most this many programs (a power of two: the
# second stage sums all partials in one block)
_SUMSQ_PROGRAMS = 1024


def l2norm_sq_torch(x: torch.Tensor, scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K9: ``(sum((x * scale)**2) in fp32,
    found_inf)``, both 0-d device tensors; the flag is set when any element
    of ``x`` is non-finite."""
    xf = x.float()
    flag = ~torch.isfinite(xf).all()
    if scale is not None:
        xf = xf * _as_float(scale)
    return (xf * xf).sum(), flag


@functools.cache
def _sumsq_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _sumsq_partial(X, S, PART, PFLAG, n, HAS_SCALE: tl.constexpr,
                       BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        bad = tl.zeros([BLOCK], dtype=tl.int32)
        for blk in range(pid, tl.cdiv(n, BLOCK), tl.num_programs(0)):
            offs = blk.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
            # |x| < inf is false exactly for inf and NaN
            bad = tl.maximum(bad, tl.where(mask & ~(tl.abs(x) < float("inf")),
                                           1, 0))
            if HAS_SCALE:
                x = x * tl.load(S)
            acc += x * x
        tl.store(PART + pid, tl.sum(acc, axis=0))
        tl.store(PFLAG + pid, tl.max(bad, axis=0))

    @triton.jit
    def _sumsq_final(PART, PFLAG, OUT, FLAG, n_part, BLOCK_P: tl.constexpr):
        offs = tl.arange(0, BLOCK_P)
        mask = offs < n_part
        tl.store(OUT, tl.sum(tl.load(PART + offs, mask=mask, other=0.0), axis=0))
        tl.store(FLAG, tl.max(tl.load(PFLAG + offs, mask=mask, other=0), axis=0))

    return triton, _sumsq_partial, _sumsq_final


def l2norm_sq_kernel(x: torch.Tensor, scale=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K9 on a 1-D contiguous CUDA tensor; returns ``(sq, found_inf)``
    as 0-d device tensors (fp32 and bool). ``scale`` (a number or a device
    scalar) multiplies each element before it is squared."""
    if not x.is_cuda or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"K9 takes a 1-D contiguous CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if not x.is_floating_point():
        raise ValueError(f"K9 takes a floating tensor, got {x.dtype}")
    triton, partial, final = _sumsq_triton()
    n = x.numel()
    progs = max(1, min(_SUMSQ_PROGRAMS, triton.cdiv(n, _BLOCK)))
    part = torch.empty(progs, dtype=torch.float32, device=x.device)
    pflag = torch.empty(progs, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    flag = torch.empty((), dtype=torch.int32, device=x.device)
    s = part if scale is None else _device_scalar(scale, x)
    partial[(progs,)](x, s, part, pflag, n, HAS_SCALE=scale is not None,
                      BLOCK=_BLOCK, num_warps=8)
    final[(1,)](part, pflag, out, flag, progs, BLOCK_P=_SUMSQ_PROGRAMS,
                num_warps=4)
    l2norm_sq_kernel.launches += 1
    return out, flag != 0


l2norm_sq_kernel.launches = 0


def l2norm_sq(x_flat: torch.Tensor, *, scale=None, impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of squares of a flat arena (the global L2 norm's reduction) and a
    non-finite flag: ``(sq, found_inf)`` as device tensors. ``scale`` folds
    a multiplier (the inverse loss scale) into every element first."""
    impl = resolve_impl(impl, x_flat, op="l2norm")
    fn = l2norm_sq_kernel if impl == "kernel" else l2norm_sq_torch
    return fn(x_flat.reshape(-1), scale)


def per_tensor_sumsq(flat: torch.Tensor, spec: ArenaSpec, segment_ids=None,
                     axis_name=None, num_tensors=None) -> torch.Tensor:
    """Per-tensor sum of squares over the arena (``spec.num_tensors``
    values, fp32): one dot product per tensor's slice, plain PyTorch (the
    JAX package computes these in jnp, outside any kernel).

    ZeRO mode: ``flat`` is one shard of the arena and ``segment_ids`` says
    which tensor owns each of its elements, either as an
    :class:`ArenaShard` (the port's form: one dot product per piece of a
    tensor the shard holds, in arena order, so two calls agree bitwise) or
    as an id tensor of ``flat``'s length (the JAX form; padding ids are
    ``num_tensors``, summed by ``scatter_add_``, whose order on the card is
    not fixed). ``num_tensors`` is then the ORIGINAL tensor count (default
    ``spec.num_tensors``). With ``axis_name`` the partial sums are summed
    over that group (one all-reduce, site ``lamb.sharded_norms``)."""
    x = flat.float()
    if segment_ids is None:
        sums = torch.stack([
            torch.dot(x[off: off + n], x[off: off + n])
            for off, n in zip(spec.offsets, (math.prod(s) for s in spec.shapes))
        ])
    elif isinstance(segment_ids, ArenaShard):
        sums = _shard_sumsq(x, segment_ids, num_tensors)
    else:
        n = spec.num_tensors if num_tensors is None else num_tensors
        sums = x.new_zeros(n + 1).scatter_add_(
            0, segment_ids.to(device=x.device, dtype=torch.int64), x * x)[:-1]
    if axis_name is not None:
        from beforeholiday_tpu_torch.monitor import comms

        sums = comms.psum(sums, axis_name, site="lamb.sharded_norms")
    return sums


def _shard_sumsq(x: torch.Tensor, seg: ArenaShard, num_tensors=None
                 ) -> torch.Tensor:
    """This shard's partial sum of squares of every tensor of ``seg.spec``
    (0 for a tensor it holds none of), in a fixed order."""
    n = seg.spec.num_tensors if num_tensors is None else num_tensors
    pieces = seg.pieces()
    sums = x.new_zeros(n)
    if pieces:
        dots = torch.stack([torch.dot(x[o: o + ln], x[o: o + ln])
                            for _, o, ln in pieces])
        sums[_piece_ids(pieces, x.device)] = dots
    return sums


@functools.lru_cache(maxsize=256)
def _piece_ids(pieces, device: torch.device) -> torch.Tensor:
    """The tensor ids of a shard's pieces on ``device``, built once."""
    return torch.tensor([t for t, _, _ in pieces], dtype=torch.int64, device=device)


def tensor_parallel_sumsq(sq: torch.Tensor, sharded, axis_name) -> torch.Tensor:
    """Per-tensor sums of squares ``sq`` with the entries of the tensors
    the tensor group shards (``sharded``: one bool a tensor) summed over the
    group, one all-reduce; the replicated ones as they are. None, or no
    sharded tensor, returns ``sq``."""
    if sharded is None or not any(sharded):
        return sq
    from beforeholiday_tpu_torch.monitor import comms

    mask = _flag_mask(tuple(map(bool, sharded)), sq.device)
    total = comms.psum(torch.where(mask, sq, 0.0), axis_name,
                       site="lamb.tensor_parallel_norms")
    return torch.where(mask, total, sq)


def tensor_parallel_norm_sq(total_sq, sharded_sq, axis_name) -> torch.Tensor:
    """A global squared norm over a tensor-parallel model from this rank's
    ``total_sq`` (every leaf it holds) and ``sharded_sq`` (the part of it
    from leaves the tensor group shards): the sharded part summed over the
    group, the replicated part once."""
    from beforeholiday_tpu_torch.monitor import comms

    return total_sq - sharded_sq + comms.psum(
        sharded_sq, axis_name, site="lamb.tensor_parallel_norms")


def sharded_sumsq(flat: torch.Tensor, spec: ArenaSpec, sharded) -> torch.Tensor:
    """The sum of squares of the arena's tensors that ``sharded`` marks."""
    mask = _flag_mask(tuple(map(bool, sharded)), flat.device)
    return torch.where(mask, per_tensor_sumsq(flat, spec), 0.0).sum()


@functools.lru_cache(maxsize=64)
def _flag_mask(flags: Tuple[bool, ...], device: torch.device) -> torch.Tensor:
    """One bool a tensor on ``device``, built once per flags and device: a
    step copies nothing from the host, so it never waits on the host."""
    return torch.tensor(flags, dtype=torch.bool, device=device)


@functools.lru_cache(maxsize=64)
def _segment_reps(spec: ArenaSpec, device: torch.device) -> torch.Tensor:
    """Each tensor's element count, then the padding's (when there is
    any), on ``device``: built once per spec and device, so expanding a
    per-tensor value copies nothing from the host."""
    sizes = [math.prod(s) for s in spec.shapes]
    pad = spec.padded_total - spec.total
    return torch.tensor(sizes + ([pad] if pad else []), device=device)


@functools.lru_cache(maxsize=256)
def _shard_reps(seg: ArenaShard, device: torch.device):
    """``(ids, reps)`` on ``device``: the tensor id of each piece of the
    shard then the padding's (``num_tensors``) when the shard ends in
    padding, and each one's element count."""
    pieces = seg.pieces()
    ids = [t for t, _, _ in pieces]
    reps = [ln for _, _, ln in pieces]
    covered = sum(reps)
    if covered < seg.shard:
        ids.append(seg.spec.num_tensors)
        reps.append(seg.shard - covered)
    return (torch.tensor(ids, dtype=torch.int64, device=device),
            torch.tensor(reps, dtype=torch.int64, device=device))


def _segment_coef(values_per_tensor: torch.Tensor, spec: ArenaSpec,
                  segment_ids=None, pad_value: float = 0.0) -> torch.Tensor:
    """A per-tensor value expanded to a per-element arena vector of
    ``spec.padded_total``, ``pad_value`` (0, as the JAX package's) on the
    padding (what the plain scaled update multiplies by). ZeRO mode:
    ``segment_ids`` (an :class:`ArenaShard`, or an id tensor with
    ``len(values_per_tensor)`` on the padding) gives the shard's vector,
    indexed by the GLOBAL tensor ids."""
    if isinstance(segment_ids, ArenaShard):
        ids, reps = _shard_reps(segment_ids, values_per_tensor.device)
        ext = torch.cat([values_per_tensor, values_per_tensor.new_full((1,), pad_value)])
        return torch.repeat_interleave(ext[ids], reps, output_size=segment_ids.shard)
    if segment_ids is not None:
        ext = torch.cat([values_per_tensor, values_per_tensor.new_full((1,), pad_value)])
        return ext[segment_ids.to(device=ext.device, dtype=torch.int64)]
    pad = spec.padded_total - spec.total
    vals = torch.cat([values_per_tensor,
                      values_per_tensor.new_full((1 if pad else 0,), pad_value)])
    return torch.repeat_interleave(
        vals, _segment_reps(spec, values_per_tensor.device),
        output_size=spec.padded_total)


def multi_tensor_l2norm(tensors: Sequence[torch.Tensor], *,
                        per_tensor: bool = False, impl: Optional[str] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Global (and optionally per-tensor) L2 norm of a tensor list:
    ``(norm, per_tensor_norms or None)``, device tensors."""
    if len(tensors) == 1 and is_arena(tensors[0]):
        flat, spec = tensors[0], None
    else:
        flat, spec = flatten(tensors)
    sq, _ = l2norm_sq(flat, impl=impl)
    norm = torch.sqrt(sq)
    if not per_tensor:
        return norm, None
    if spec is None:
        return norm, norm.reshape(1)
    return norm, torch.sqrt(per_tensor_sumsq(flat, spec))


# ------------------------------------------------------------------ K7


def lamb_stage1_torch(g, p, m, v, *, beta1, beta2, beta3, bc1, bc2, eps,
                      weight_decay, clip, mode, found_inf) -> torch.Tensor:
    """Plain PyTorch version of K7: returns ``u`` (fp32, new) and updates
    ``m`` and ``v`` in place, with the same fp32 arithmetic."""
    gf, pf, mf, vf = g.float(), p.float(), m.float(), v.float()
    sg = gf / _as_float(clip)
    if mode == 0:
        sg = sg + weight_decay * pf
    m_new = mf * beta1 + beta3 * sg
    v_new = vf * beta2 + (1.0 - beta2) * sg * sg
    u = (m_new / _as_float(bc1)) / (torch.sqrt(v_new / _as_float(bc2)) + eps)
    if mode == 1:
        u = u + weight_decay * pf
    if found_inf is not None:
        # the skip step holds the moments too, or one overflow poisons them
        skip = torch.as_tensor(found_inf, device=p.device) != 0
        m_new = torch.where(skip, mf, m_new)
        v_new = torch.where(skip, vf, v_new)
        u = torch.where(skip, 0.0, u)
    m.copy_(m_new)
    v.copy_(v_new)
    return u


@functools.cache
def _lamb1_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _lamb1(G, P, M, V, U, SCAL, FI, n, beta1, beta2, beta3, one_m_b2, eps,
               decay, MODE: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        inb = offs < n
        skip = tl.load(FI) != 0
        # found_inf: no moment is loaded or stored, and u is written as 0
        mask = inb & ~skip
        bc1 = tl.load(SCAL)
        bc2 = tl.load(SCAL + 1)
        clip = tl.load(SCAL + 2)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(M + offs, mask=mask, other=0.0)
        v = tl.load(V + offs, mask=mask, other=0.0)
        sg = tl.div_rn(g, clip)
        if MODE == 0:  # L2: decay folded into the gradient
            sg = sg + decay * p
        m_new = m * beta1 + beta3 * sg
        v_new = v * beta2 + one_m_b2 * sg * sg
        u = tl.div_rn(tl.div_rn(m_new, bc1),
                      tl.sqrt_rn(tl.div_rn(v_new, bc2)) + eps)
        if MODE == 1:  # decoupled decay added to the update
            u = u + decay * p
        tl.store(U + offs, tl.where(skip, 0.0, u), mask=inb)
        tl.store(M + offs, m_new, mask=mask)
        tl.store(V + offs, v_new, mask=mask)

    return triton, _lamb1


def lamb_stage1_kernel(g, p, m, v, *, beta1, beta2, beta3, bc1, bc2, eps,
                       weight_decay, clip, mode, found_inf) -> torch.Tensor:
    """Launch K7 on flat CUDA arenas: fp32 ``m``/``v`` updated in place,
    ``g`` and ``p`` of any float dtype; returns the fp32 update ``u``."""
    n = p.numel()
    for t in (g, p, m, v):
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError("K7 takes 1-D contiguous CUDA arenas of one "
                             f"length on one device; got {tuple(t.shape)} "
                             f"on {t.device}")
    if not (m.dtype == v.dtype == torch.float32):
        raise ValueError(f"K7 updates fp32 m/v, got {m.dtype}/{v.dtype}")
    if not (g.is_floating_point() and p.is_floating_point()):
        raise ValueError(f"K7 takes floating g and p, got {g.dtype}/{p.dtype}")
    triton, kernel = _lamb1_triton()
    scal = torch.cat([_device_scalar(x, p) for x in (bc1, bc2, clip)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    u = torch.empty(n, dtype=torch.float32, device=p.device)
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](
            g, p, m, v, u, scal, fi, n, float(beta1), float(beta2),
            float(beta3), float(1.0 - beta2), float(eps), float(weight_decay),
            MODE=mode, BLOCK=_BLOCK, num_warps=8)
        lamb_stage1_kernel.launches += 1
    return u


lamb_stage1_kernel.launches = 0


def lamb_stage1(g_flat, p_flat, m_flat, v_flat, *, beta1, beta2, beta3,
                bias_correction1, bias_correction2, eps, weight_decay,
                clipped_global_grad_norm, mode: int = 1, found_inf=None,
                impl: Optional[str] = None):
    """LAMB stage 1 over flat arenas: returns ``(u, m, v)``, ``m`` and ``v``
    updated in place and ``u`` a new fp32 arena (0 everywhere on
    ``found_inf``, where the moments are held)."""
    impl = resolve_impl(impl, p_flat, op="lamb_stage1")
    fn = lamb_stage1_kernel if impl == "kernel" else lamb_stage1_torch
    u = fn(g_flat, p_flat, m_flat, v_flat, beta1=beta1, beta2=beta2,
           beta3=beta3, bc1=bias_correction1, bc2=bias_correction2, eps=eps,
           weight_decay=weight_decay, clip=clipped_global_grad_norm,
           mode=mode, found_inf=found_inf)
    return u, m_flat, v_flat


# ------------------------------------------------------------------ K8


def scaled_update_torch(p, u, ratio, spec: ArenaSpec, *, found_inf, copy_out,
                        shard: Optional[ArenaShard] = None):
    """Plain PyTorch version of K8, in place on ``p`` (and ``copy_out``):
    ``p -= coef * u`` with ``coef`` the per-tensor ``ratio`` expanded over
    the arena (:func:`_segment_coef`), held on ``found_inf``. ``shard``: p
    and u are that shard of the arena, ``ratio`` still one value per tensor
    of ``spec`` (global ids)."""
    pf = p.float()
    p_new = pf - _segment_coef(ratio.float(), spec, shard) * u.float()
    if found_inf is not None:
        p_new = torch.where(torch.as_tensor(found_inf, device=p.device) != 0,
                            pf, p_new)
    p.copy_(p_new)
    if copy_out is not None:
        copy_out.copy_(p_new)


@functools.lru_cache(maxsize=64)
def _segment_tables(spec: ArenaSpec, device: torch.device, base: int = 0,
                    n: Optional[int] = None):
    """K8's per-block lookup for ``spec``'s arena: for block ``b`` of
    ``_BLOCK`` elements, the tensor holding its first element and the count
    of tensor starts inside it; and the starts themselves, with the
    padding's start (``spec.total``, tensor ``num_tensors``) last. Built on
    the host once per spec and device.

    Shard mode: the launch covers the ``n`` elements from arena offset
    ``base`` (a ZeRO shard), so every start is taken relative to ``base``
    (a tensor that began before the shard starts below 0). The first
    tensor and every ``STARTS`` index stay GLOBAL ids, and positions past
    the arena's tensors fall in the padding's segment, ratio 0."""
    n = spec.padded_total if n is None else n
    starts = np.array(spec.offsets + (spec.total,), dtype=np.int64) - base
    lo = np.arange(-(-n // _BLOCK), dtype=np.int64) * _BLOCK
    first = np.searchsorted(starts, lo, side="right") - 1
    span = np.maximum(np.searchsorted(starts, lo + _BLOCK, side="left")
                      - first - 1, 0)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (first.astype(np.int32), span.astype(np.int32), starts))


@functools.cache
def _scaled_update_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _scaled_update(P, U, RATIO, FIRST, SPAN, STARTS, C, FI, n,
                       HAS_COPY: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < n) & (tl.load(FI) == 0)
        # each element's tensor: the block's first one, plus one for every
        # tensor start inside the block at or before the element
        first = tl.load(FIRST + pid)
        seg = tl.zeros([BLOCK], dtype=tl.int32) + first
        for j in range(0, tl.load(SPAN + pid)):
            seg += (offs >= tl.load(STARTS + first + 1 + j)).to(tl.int32)
        c = tl.load(RATIO + seg, mask=mask, other=0.0)
        p = tl.load(P + offs, mask=mask, other=0.0)
        u = tl.load(U + offs, mask=mask, other=0.0)
        p_new = p - c * u
        tl.store(P + offs, p_new, mask=mask)
        if HAS_COPY:
            tl.store(C + offs, p_new.to(C.dtype.element_ty), mask=mask)

    return triton, _scaled_update


def scaled_update_kernel(p, u, ratio, spec: ArenaSpec, *, found_inf, copy_out,
                         shard: Optional[ArenaShard] = None):
    """Launch K8 on flat CUDA arenas of ``spec.padded_total`` elements: fp32
    ``p`` updated in place, fp32 ``u``, ``ratio`` one fp32 value per spec
    tensor, optional ``copy_out`` of any float dtype. ``shard`` (of
    ``spec``'s arena): p, u and the copy are that shard's ``shard.shard``
    elements, ``ratio`` still one value per tensor of ``spec``; only K8's
    tables change (:func:`_segment_tables` from the shard's base)."""
    if shard is not None and shard.spec != spec:
        raise ValueError("K8's shard is of another arena than spec")
    n = spec.padded_total if shard is None else shard.shard
    arenas = (p, u) + (() if copy_out is None else (copy_out,))
    for t in arenas:
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"K8 takes 1-D contiguous CUDA arenas of the "
                             f"spec's (or shard's) {n} elements on one device; got "
                             f"{tuple(t.shape)} on {t.device}")
    if not (p.dtype == u.dtype == torch.float32):
        raise ValueError(f"K8 updates fp32 p with fp32 u, got {p.dtype}/{u.dtype}")
    if ratio.shape != (spec.num_tensors,) or ratio.device != p.device:
        raise ValueError(f"K8 takes one ratio per spec tensor "
                         f"({spec.num_tensors},) on {p.device}, got "
                         f"{tuple(ratio.shape)} on {ratio.device}")
    triton, kernel = _scaled_update_triton()
    first, span, starts = (_segment_tables(spec, p.device) if shard is None
                           else _segment_tables(spec, p.device, shard.base, n))
    # the padding's ratio is 0, as _segment_coef makes it
    ratio_ext = torch.cat([ratio.float(), ratio.new_zeros(1, dtype=torch.float32)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](
            p, u, ratio_ext, first, span, starts,
            p if copy_out is None else copy_out, fi, n,
            HAS_COPY=copy_out is not None, BLOCK=_BLOCK, num_warps=8)
        scaled_update_kernel.launches += 1


scaled_update_kernel.launches = 0


def apply_scaled_update(p_flat, u_flat, ratio, spec: ArenaSpec, *,
                        found_inf=None, model_copy=None,
                        impl: Optional[str] = None,
                        shard: Optional[ArenaShard] = None):
    """``p -= ratio[tensor] * u`` over a flat arena, in place (held on
    ``found_inf``); ``model_copy`` receives the new params in its own dtype
    in the same pass. The JAX function takes the expanded per-element
    coefficient arena; this one takes the per-tensor ``ratio`` and the spec
    (the plain version expands it with :func:`_segment_coef`). ``shard``:
    the arenas are that ZeRO shard of ``spec``'s arena."""
    impl = resolve_impl(impl, p_flat, op="scaled_update")
    fn = scaled_update_kernel if impl == "kernel" else scaled_update_torch
    fn(p_flat, u_flat, ratio, spec, found_inf=found_inf, copy_out=model_copy,
       shard=shard)
    return p_flat if model_copy is None else (p_flat, model_copy)


# ----------------------------------------------------------------- LAMB


def lamb_flat(gf, pf, mf, vf, spec: ArenaSpec, *, lr, beta1: float = 0.9,
              beta2: float = 0.999, eps: float = 1e-6, step=1,
              bias_correction: bool = True, weight_decay: float = 0.0,
              grad_averaging: bool = True, mode: int = 1,
              global_grad_norm=None, max_grad_norm: float = 1.0,
              use_nvlamb: bool = False, found_inf=None, model_copy_dtype=None,
              model_copy=None, impl: Optional[str] = None,
              tensor_sharded=None, axis_name: str = "tensor",
              _sharded_norms=None):
    """Fused LAMB over flat arenas, IN PLACE on ``pf``, ``mf`` and ``vf``:
    K7 (stage 1), the per-tensor norms of p and u from ``spec``, the trust
    ratios, then K8 (stage 2) with the model copy. ``step`` and
    ``global_grad_norm`` may be device tensors; without ``global_grad_norm``
    the norm is this arena's own (K9). ``tensor_sharded`` (one bool a tensor
    of ``spec``) marks the tensors sharded over the tensor group
    ``axis_name``: their norms are the whole tensors', squares summed over
    the group (JAX's GSPMD sees the whole tensor), and so is their part of
    the own-arena norm. Returns ``(p, m, v)`` or ``(p, m, v, model_copy)``.

    ZeRO mode, ``_sharded_norms=(shard, num_tensors, axis_name)``: the
    arenas are the :class:`ArenaShard` ``shard`` of an arena of
    ``num_tensors`` tensors (``shard.spec``, which then stands for
    ``spec``); the trust-ratio norms are the shard's per-tensor partial sums
    summed over ``axis_name``, indexed by the global tensor ids, and K8 runs
    on the shard's tables. Pass ``global_grad_norm`` (the shard's own norm
    is not the model's)."""
    shard = None
    if _sharded_norms is not None:
        shard, n_tensors, norm_axis = _sharded_norms
        if not isinstance(shard, ArenaShard):
            raise TypeError("the port's _sharded_norms carries an ArenaShard "
                            "(spec, rank, shard), not an id array")
        if tensor_sharded is not None or global_grad_norm is None:
            raise ValueError("sharded LAMB takes the global grad norm and no "
                             "tensor_sharded mask")
        spec = shard.spec
    impl = resolve_impl(impl, pf, op="lamb")
    if model_copy is None and model_copy_dtype is not None:
        model_copy = torch.empty(pf.shape, dtype=model_copy_dtype,
                                 device=pf.device)
    bc1, bc2 = _bias_corrections(bias_correction, step, beta1, beta2)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    if global_grad_norm is None:
        sq = l2norm_sq(gf, impl=impl)[0]
        if tensor_sharded is not None and any(tensor_sharded):
            sq = tensor_parallel_norm_sq(sq, sharded_sumsq(gf, spec, tensor_sharded),
                                         axis_name)
        global_grad_norm = torch.sqrt(sq)
    ggn = _device_scalar(global_grad_norm, pf).reshape(())
    # NaN compares false: a NaN norm leaves the divisor at 1, as in JAX
    clipped = torch.where(ggn > max_grad_norm, ggn / max_grad_norm,
                          torch.ones((), device=pf.device))
    def norms(x):
        if shard is not None:
            return torch.sqrt(per_tensor_sumsq(x, spec, shard, norm_axis, n_tensors))
        return torch.sqrt(tensor_parallel_sumsq(per_tensor_sumsq(x, spec),
                                                tensor_sharded, axis_name))

    # per-tensor norms of p before stage 2 moves it
    p_norm = norms(pf)
    u, _, _ = lamb_stage1(gf, pf, mf, vf, beta1=beta1, beta2=beta2,
                          beta3=beta3, bias_correction1=bc1,
                          bias_correction2=bc2, eps=eps,
                          weight_decay=weight_decay,
                          clipped_global_grad_norm=clipped, mode=mode,
                          found_inf=found_inf, impl=impl)
    u_norm = norms(u)
    lr_t = _device_scalar(lr, pf).reshape(())
    if use_nvlamb or weight_decay != 0.0:
        ratio = torch.where((p_norm != 0.0) & (u_norm != 0.0),
                            lr_t * (p_norm / u_norm), lr_t)
    else:
        ratio = lr_t.expand(p_norm.shape)
    apply_scaled_update(pf, u, ratio.contiguous(), spec, found_inf=found_inf,
                        model_copy=model_copy, impl=impl, shard=shard)
    outs = (pf, mf, vf)
    return outs if model_copy is None else outs + (model_copy,)


def multi_tensor_lamb(grads, params, exp_avgs, exp_avg_sqs, *, lr,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, step=1, bias_correction: bool = True,
                      weight_decay: float = 0.0, grad_averaging: bool = True,
                      mode: int = 1, global_grad_norm=None,
                      max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                      found_inf=None, impl: Optional[str] = None,
                      tensor_sharded=None, axis_name: str = "tensor",
                      _sharded_norms=None):
    """Fused LAMB over tensor lists; returns new ``(params, m, v)`` lists
    (views of freshly packed arenas — the inputs are not modified). The
    trust ratios are per tensor of the list (``tensor_sharded`` as
    :func:`lamb_flat`'s); ``found_inf`` turns the whole update into the
    identity."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(exp_avgs)
    vf, _ = flatten(exp_avg_sqs)
    lamb_flat(gf, pf, mf, vf, spec, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              step=step, bias_correction=bias_correction,
              weight_decay=weight_decay, grad_averaging=grad_averaging,
              mode=mode, global_grad_norm=global_grad_norm,
              max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
              found_inf=found_inf, impl=impl, tensor_sharded=tensor_sharded,
              axis_name=axis_name, _sharded_norms=_sharded_norms)
    return unflatten(pf, spec), unflatten(mf, spec), unflatten(vf, spec)


# ----------------------------------------------------------------- K10


def sgd_torch(g, p, m, *, lr, weight_decay, momentum, dampening, nesterov,
              first_run, wd_after_momentum, scale, found_inf, copy_out):
    """Plain PyTorch version of K10, in place on ``p`` and ``m`` (and
    ``copy_out`` when given), with the same fp32 arithmetic. ``first_run``
    (a bool or a device tensor) seeds the momentum buffer with the gradient,
    with no dampening, as torch's SGD does on its first step."""
    gf = g.float() * _as_float(scale)
    pf, mf = p.float(), m.float()
    if not wd_after_momentum:
        gf = gf + weight_decay * pf
    if momentum != 0.0:
        blend = mf * momentum + (1.0 - dampening) * gf
        if isinstance(first_run, torch.Tensor):
            m_new = torch.where(first_run.to(p.device) != 0, gf, blend)
        else:
            m_new = gf if first_run else blend
        step = gf + momentum * m_new if nesterov else m_new
    else:
        m_new, step = mf, gf
    if wd_after_momentum:
        step = step + weight_decay * pf
    p_new = pf - _as_float(lr) * step
    if found_inf is not None:
        skip = torch.as_tensor(found_inf, device=p.device) != 0
        p_new = torch.where(skip, pf, p_new)
        m_new = torch.where(skip, mf, m_new)
    p.copy_(p_new)
    m.copy_(m_new)
    if copy_out is not None:
        copy_out.copy_(p_new)


@functools.cache
def _sgd_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _sgd(G, P, M, C, SCAL, FI, FIRST, n, decay, momentum, one_m_damp,
             NESTEROV: tl.constexpr, WD_AFTER: tl.constexpr,
             HAS_MOMENTUM: tl.constexpr, HAS_COPY: tl.constexpr,
             BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < n) & (tl.load(FI) == 0)
        lr = tl.load(SCAL)
        gs = tl.load(SCAL + 1)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32) * gs
        p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
        # every multiply-add is an explicit fma: the compiler has none left
        # to contract, so the arena and views modes round alike
        if not WD_AFTER:  # decay folded into the gradient before momentum
            g = tl.fma(decay, p, g)
        if HAS_MOMENTUM:
            first = tl.load(FIRST) != 0
            # the first step seeds the buffer with g and never reads it
            m = tl.load(M + offs, mask=mask & (tl.load(FIRST) == 0), other=0.0)
            m_new = tl.where(first, g, tl.fma(m, momentum, one_m_damp * g))
            tl.store(M + offs, m_new, mask=mask)
            if NESTEROV:
                step = tl.fma(momentum, m_new, g)
            else:
                step = m_new
        else:
            step = g
        if WD_AFTER:
            step = tl.fma(decay, p, step)
        p_new = tl.fma(-lr, step, p)
        tl.store(P + offs, p_new.to(P.dtype.element_ty), mask=mask)
        if HAS_COPY:
            tl.store(C + offs, p_new.to(C.dtype.element_ty), mask=mask)

    return triton, _sgd


def sgd_kernel(g, p, m, *, lr, weight_decay, momentum, dampening, nesterov,
               first_run, wd_after_momentum, scale, found_inf, copy_out):
    """Launch K10 on flat CUDA arenas: ``p`` (fp32, bf16 or fp16) and fp32
    ``m`` updated in place, ``g`` fp32/bf16/fp16, optional ``copy_out`` of
    any float dtype.
    ``lr`` and ``scale`` may be numbers or device scalars; ``first_run`` and
    ``found_inf`` are read from device memory by the kernel."""
    arenas = (g, p, m) + (() if copy_out is None else (copy_out,))
    n = p.numel()
    for t in arenas:
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError("K10 takes 1-D contiguous CUDA arenas of one "
                             f"length on one device; got {tuple(t.shape)} "
                             f"on {t.device}")
    if p.dtype not in _HALF_OR_FP32 or m.dtype != torch.float32:
        raise ValueError(f"K10 updates fp32, bf16 or fp16 p and fp32 m, got "
                         f"{p.dtype}/{m.dtype}")
    if not g.is_floating_point():
        raise ValueError(f"K10 takes a floating gradient, got {g.dtype}")
    triton, kernel = _sgd_triton()
    scal = torch.cat([_device_scalar(x, p) for x in (lr, scale)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    first = _device_scalar(first_run, p, torch.int32)
    if n:
        kernel[(triton.cdiv(n, _BLOCK),)](
            g, p, m, p if copy_out is None else copy_out, scal, fi, first, n,
            float(weight_decay), float(momentum), float(1.0 - dampening),
            NESTEROV=bool(nesterov), WD_AFTER=bool(wd_after_momentum),
            HAS_MOMENTUM=momentum != 0.0, HAS_COPY=copy_out is not None,
            BLOCK=_BLOCK, num_warps=8,
        )
        sgd_kernel.launches += 1


sgd_kernel.launches = 0


def sgd_flat(gf, pf, mf, *, lr, weight_decay: float = 0.0,
             momentum: float = 0.0, dampening: float = 0.0,
             nesterov: bool = False, first_run=False,
             wd_after_momentum: bool = False, scale=1.0,
             model_copy_dtype=None, found_inf=None, model_copy=None,
             impl: Optional[str] = None):
    """Fused SGD over flat arenas, IN PLACE: ``pf`` and ``mf`` are updated
    and returned (the JAX package returns new arrays; its TPU kernel aliases
    them the same way). ``first_run`` may be a device tensor (``step == 0``),
    ``lr`` and ``scale`` device scalars. ``model_copy`` (a tensor of ``pf``'s
    length) receives the new params in its own dtype in the same pass;
    ``model_copy_dtype`` allocates one. Returns ``(params, momentums)`` or
    ``(params, momentums, model_copy)``."""
    impl = resolve_impl(impl, pf, op="sgd")
    if model_copy is None and model_copy_dtype is not None:
        model_copy = torch.empty(pf.shape, dtype=model_copy_dtype,
                                 device=pf.device)
    fn = sgd_kernel if impl == "kernel" else sgd_torch
    fn(gf, pf, mf, lr=lr, weight_decay=weight_decay, momentum=momentum,
       dampening=dampening, nesterov=nesterov, first_run=first_run,
       wd_after_momentum=wd_after_momentum, scale=scale, found_inf=found_inf,
       copy_out=model_copy)
    return (pf, mf) if model_copy is None else (pf, mf, model_copy)


def sgd_views_torch(gleaves, p, m, spec: ArenaSpec, *, copy_out, **hyper):
    """Plain PyTorch version of K10's views mode: :func:`sgd_torch` leaf by
    leaf on the arenas' views, in place."""
    for g, off, shape in zip(gleaves, spec.offsets, spec.shapes):
        n = math.prod(shape)
        sgd_torch(g.reshape(-1), p[off: off + n], m[off: off + n],
                  copy_out=None if copy_out is None else copy_out[off: off + n],
                  **hyper)


@functools.cache
def _sgd_views_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _sgd_views(TAB, BMAP, GT, P, M, C, SCAL, FI, FIRST, decay, momentum,
                   one_m_damp, NESTEROV: tl.constexpr, WD_AFTER: tl.constexpr,
                   HAS_MOMENTUM: tl.constexpr, HAS_COPY: tl.constexpr,
                   BLOCK: tl.constexpr):
        b = tl.program_id(0)
        leaf = tl.load(BMAP + 2 * b).to(tl.int64)
        chunk = tl.load(BMAP + 2 * b + 1).to(tl.int64)
        g_ptr = tl.load(TAB + 3 * leaf).to(tl.pointer_type(GT.dtype.element_ty))
        count = tl.load(TAB + 3 * leaf + 1)
        base = tl.load(TAB + 3 * leaf + 2)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < count) & (tl.load(FI) == 0)
        lr = tl.load(SCAL)
        gs = tl.load(SCAL + 1)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * gs
        p = tl.load(P + base + offs, mask=mask, other=0.0).to(tl.float32)
        # the arena launch's explicit fmas, so the two round alike
        if not WD_AFTER:
            g = tl.fma(decay, p, g)
        if HAS_MOMENTUM:
            first = tl.load(FIRST) != 0
            m = tl.load(M + base + offs, mask=mask & (tl.load(FIRST) == 0), other=0.0)
            m_new = tl.where(first, g, tl.fma(m, momentum, one_m_damp * g))
            tl.store(M + base + offs, m_new, mask=mask)
            if NESTEROV:
                step = tl.fma(momentum, m_new, g)
            else:
                step = m_new
        else:
            step = g
        if WD_AFTER:
            step = tl.fma(decay, p, step)
        p_new = tl.fma(-lr, step, p)
        tl.store(P + base + offs, p_new.to(P.dtype.element_ty), mask=mask)
        if HAS_COPY:
            tl.store(C + base + offs, p_new.to(C.dtype.element_ty), mask=mask)

    return triton, _sgd_views


def sgd_views_kernel(gleaves, p, m, spec: ArenaSpec, *, lr, weight_decay, momentum,
                     dampening, nesterov, first_run, wd_after_momentum, scale,
                     found_inf, copy_out):
    """Launch K10's views mode: arenas ``p`` (fp32, bf16 or fp16) and fp32
    ``m`` of ``spec`` updated in place from the gradient leaves where they
    lie (one floating dtype), optional ``copy_out`` arena. One launch."""
    _check_views("K10 views", gleaves, spec, (p, m, copy_out))
    for t in (p, m) + (() if copy_out is None else (copy_out,)):
        if not t.is_cuda or t.device != p.device or not t.is_contiguous():
            raise ValueError("K10 views updates contiguous CUDA arenas on one "
                             f"device; got {t.device}")
    if p.dtype not in _HALF_OR_FP32 or m.dtype != torch.float32:
        raise ValueError(f"K10 updates fp32, bf16 or fp16 p and fp32 m, got "
                         f"{p.dtype}/{m.dtype}")
    table, bmap, blocks = _views_launch_args("K10 views", gleaves, spec, p)
    triton, kernel = _sgd_views_triton()
    scal = torch.cat([_device_scalar(x, p) for x in (lr, scale)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    first = _device_scalar(first_run, p, torch.int32)
    if blocks:
        kernel[(blocks,)](
            table, bmap, gleaves[0], p, m, p if copy_out is None else copy_out,
            scal, fi, first, float(weight_decay), float(momentum),
            float(1.0 - dampening), NESTEROV=bool(nesterov),
            WD_AFTER=bool(wd_after_momentum), HAS_MOMENTUM=momentum != 0.0,
            HAS_COPY=copy_out is not None, BLOCK=_BLOCK, num_warps=8)
        sgd_views_kernel.launches += 1


sgd_views_kernel.launches = 0


def sgd_views(gleaves, pf, mf, spec: ArenaSpec, *, lr, weight_decay: float = 0.0,
              momentum: float = 0.0, dampening: float = 0.0, nesterov: bool = False,
              first_run=False, wd_after_momentum: bool = False, scale=1.0,
              found_inf=None, model_copy=None, impl: Optional[str] = None):
    """:func:`sgd_flat` with the gradients as a list of leaves laid out by
    ``spec`` (K10's views mode on CUDA arenas, the plain per-leaf version
    on CPU ones), IN PLACE; returns ``(p, m)`` or ``(p, m, model_copy)``."""
    impl = resolve_impl(impl, pf, op="sgd_views")
    fn = sgd_views_kernel if impl == "kernel" else sgd_views_torch
    fn(list(gleaves), pf, mf, spec, lr=lr, weight_decay=weight_decay,
       momentum=momentum, dampening=dampening, nesterov=nesterov,
       first_run=first_run, wd_after_momentum=wd_after_momentum, scale=scale,
       found_inf=found_inf, copy_out=model_copy)
    return (pf, mf) if model_copy is None else (pf, mf, model_copy)


def multi_tensor_sgd(grads, params, momentums, *, lr, weight_decay: float = 0.0,
                     momentum: float = 0.0, dampening: float = 0.0,
                     nesterov: bool = False, first_run=False,
                     wd_after_momentum: bool = False, scale=1.0,
                     model_copy_dtype=None, found_inf=None,
                     impl: Optional[str] = None):
    """Fused SGD over tensor lists; returns new ``(params, momentums[,
    model_copies])`` lists (views of freshly packed arenas — the inputs are
    not modified). ``model_copy_dtype`` also writes a low-precision copy of
    the new params, the reference's 4-list variant."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(momentums)
    outs = sgd_flat(gf, pf, mf, lr=lr, weight_decay=weight_decay,
                    momentum=momentum, dampening=dampening, nesterov=nesterov,
                    first_run=first_run, wd_after_momentum=wd_after_momentum,
                    scale=scale, model_copy_dtype=model_copy_dtype,
                    found_inf=found_inf, impl=impl)
    return tuple(unflatten(o, spec) for o in outs)


# ----------------------------------------------------------------- LARS


def multi_tensor_lars(grads, params, momentums, *, lr,
                      trust_coefficient: float = 0.001, epsilon: float = 0.0,
                      weight_decay: float = 0.0, momentum: float = 0.0,
                      dampening: float = 0.0, nesterov: bool = False,
                      first_run=False, wd_after_momentum: bool = False,
                      scale=1.0, found_inf=None, impl: Optional[str] = None):
    """Fused LARS over tensor lists; returns new ``(params, momentums)``
    lists. The per-tensor trust ratio ``tc·‖p‖ / (‖g‖ + wd·‖p‖ + eps)``
    (1 where either norm is 0) scales the whole step, decay included:
    ``g' = trust·(scale·g + wd·p)`` in plain PyTorch, then K10 runs on g'
    with no decay and no scale. With the decay folded in before momentum,
    ``wd_after_momentum`` has nothing left to act on and is dropped, as in
    the JAX package."""
    del wd_after_momentum
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(momentums)
    g_norm = torch.sqrt(per_tensor_sumsq(gf, spec)) * _as_float(scale)
    p_norm = torch.sqrt(per_tensor_sumsq(pf, spec))
    trust = torch.where((g_norm != 0.0) & (p_norm != 0.0),
                        trust_coefficient * p_norm
                        / (g_norm + weight_decay * p_norm + epsilon), 1.0)
    g_eff = _segment_coef(trust, spec) * (gf.float() * _as_float(scale)
                                          + weight_decay * pf.float())
    sgd_flat(g_eff.to(gf.dtype), pf, mf, lr=lr, weight_decay=0.0,
             momentum=momentum, dampening=dampening, nesterov=nesterov,
             first_run=first_run, wd_after_momentum=False, scale=1.0,
             found_inf=found_inf, impl=impl)
    return unflatten(pf, spec), unflatten(mf, spec)


# ----------------------------------------------------------------- K18


def novograd_torch(g, p, m, denom, spec: ArenaSpec, *, beta1, beta3, bc1, lr,
                   weight_decay, mode, found_inf):
    """Plain PyTorch version of K18, in place on ``p`` and ``m`` (arenas of
    ``spec.padded_total``), with the same fp32 arithmetic. ``denom`` holds
    one value per spec tensor, expanded over the arena by
    :func:`_segment_coef` with 1 on the padding, so the padding stays 0."""
    gf, pf, mf = g.float(), p.float(), m.float()
    d = _segment_coef(denom.float(), spec, pad_value=1.0)
    if mode == 0:
        m_new = beta1 * mf + beta3 * (gf / d + weight_decay * pf)
        p_new = pf - _as_float(lr) * (m_new / _as_float(bc1))
    else:
        m_new = beta1 * mf + beta3 * gf
        p_new = pf - _as_float(lr) * ((m_new / _as_float(bc1)) / d
                                      + weight_decay * pf)
    if found_inf is not None:
        skip = torch.as_tensor(found_inf, device=p.device) != 0
        p_new = torch.where(skip, pf, p_new)
        m_new = torch.where(skip, mf, m_new)
    p.copy_(p_new)
    m.copy_(m_new)


@functools.cache
def _novograd_triton():
    global tl
    triton = _triton()
    import triton.language as tl

    @triton.jit
    def _novograd(G, P, M, DENOM, FIRST, SPAN, STARTS, SCAL, FI, n, beta1,
                  beta3, decay, MODE: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        # found_inf masks every load and store: a skipped step touches nothing
        mask = (offs < n) & (tl.load(FI) == 0)
        # each element's tensor, found as K8 finds it: the block's first
        # tensor, plus one for every tensor start inside the block at or
        # before the element
        first = tl.load(FIRST + pid)
        seg = tl.zeros([BLOCK], dtype=tl.int32) + first
        for j in range(0, tl.load(SPAN + pid)):
            seg += (offs >= tl.load(STARTS + first + 1 + j)).to(tl.int32)
        d = tl.load(DENOM + seg, mask=mask, other=1.0)
        bc1 = tl.load(SCAL)
        lr = tl.load(SCAL + 1)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(P + offs, mask=mask, other=0.0)
        m = tl.load(M + offs, mask=mask, other=0.0)
        if MODE == 0:  # the decay inside the moment
            m_new = beta1 * m + beta3 * (tl.div_rn(g, d) + decay * p)
            update = tl.div_rn(m_new, bc1)
        else:  # the decay added to the update
            m_new = beta1 * m + beta3 * g
            update = tl.div_rn(tl.div_rn(m_new, bc1), d) + decay * p
        tl.store(P + offs, p - lr * update, mask=mask)
        tl.store(M + offs, m_new, mask=mask)

    return triton, _novograd


def novograd_kernel(g, p, m, denom, spec: ArenaSpec, *, beta1, beta3, bc1, lr,
                    weight_decay, mode, found_inf):
    """Launch K18 on flat CUDA arenas of ``spec.padded_total`` elements:
    fp32 ``p`` and ``m`` updated in place, ``g`` of any float dtype,
    ``denom`` one fp32 value per spec tensor on the card, read through K8's
    per-block segment table (the padding's denominator is 1). ``bc1`` and
    ``lr`` may be numbers or device scalars."""
    n = spec.padded_total
    for t in (g, p, m):
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"K18 takes 1-D contiguous CUDA arenas of the "
                             f"spec's {n} elements on one device; got "
                             f"{tuple(t.shape)} on {t.device}")
    if not (p.dtype == m.dtype == torch.float32):
        raise ValueError(f"K18 updates fp32 p/m, got {p.dtype}/{m.dtype}")
    if not g.is_floating_point():
        raise ValueError(f"K18 takes a floating gradient, got {g.dtype}")
    if denom.shape != (spec.num_tensors,) or denom.device != p.device:
        raise ValueError(f"K18 takes one denominator per spec tensor "
                         f"({spec.num_tensors},) on {p.device}, got "
                         f"{tuple(denom.shape)} on {denom.device}")
    triton, kernel = _novograd_triton()
    first, span, starts = _segment_tables(spec, p.device)
    denom_ext = torch.cat([denom.float(), denom.new_ones(1, dtype=torch.float32)])
    scal = torch.cat([_device_scalar(bc1, p), _device_scalar(lr, p)])
    fi = (torch.zeros(1, dtype=torch.int32, device=p.device) if found_inf is None
          else _device_scalar(found_inf, p, torch.int32))
    kernel[(triton.cdiv(n, _BLOCK),)](
        g, p, m, denom_ext, first, span, starts, scal, fi, n, float(beta1),
        float(beta3), float(weight_decay), MODE=mode, BLOCK=_BLOCK,
        num_warps=8)
    novograd_kernel.launches += 1


novograd_kernel.launches = 0


def multi_tensor_novograd(grads, params, exp_avgs, grad_norms: torch.Tensor, *,
                          lr, beta1: float = 0.95, beta2: float = 0.98,
                          eps: float = 1e-8, step=1, bias_correction: bool = True,
                          weight_decay: float = 0.0, grad_averaging: bool = True,
                          moment_mode: int = 0, found_inf=None,
                          impl: Optional[str] = None):
    """Fused NovoGrad over tensor lists. ``grad_norms`` is the per-tensor
    second moment v (one fp32 value per tensor); returns new ``(params, m,
    v)``, the lists views of freshly packed arenas. As the reference
    launcher: v = ‖g‖² on step 1, else β2·v + (1−β2)·‖g‖², held on
    ``found_inf``; denom = √v / bc2 + eps with bc2 = √(1−β2ᵗ). ``step`` may
    be a device tensor. The per-tensor sums of squares are plain PyTorch,
    as the JAX package computes them in jnp."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(exp_avgs)
    impl = resolve_impl(impl, pf, op="novograd")
    step_f = _device_scalar(step, pf).reshape(())
    if bias_correction:
        bc1 = 1.0 - torch.pow(beta1, step_f)
        bc2 = torch.sqrt(1.0 - torch.pow(beta2, step_f))
    else:
        bc1, bc2 = 1.0, 1.0
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    v = grad_norms.float()
    gnorm_sq = per_tensor_sumsq(gf, spec)
    v_new = torch.where(step_f <= 1.0, gnorm_sq,
                        beta2 * v + (1.0 - beta2) * gnorm_sq)
    if found_inf is not None:
        v_new = torch.where(torch.as_tensor(found_inf, device=pf.device) != 0,
                            v, v_new)
    denom = torch.sqrt(v_new) / _as_float(bc2) + eps
    fn = novograd_kernel if impl == "kernel" else novograd_torch
    fn(gf, pf, mf, denom, spec, beta1=beta1, beta3=beta3, bc1=bc1, lr=lr,
       weight_decay=weight_decay, mode=moment_mode, found_inf=found_inf)
    return unflatten(pf, spec), unflatten(mf, spec), v_new
