"""Multi-tensor ops over flat arenas — counterpart of
``beforeholiday_tpu/ops/multi_tensor.py`` (the reference's ``amp_C``).

Five kernels, all Triton, all streaming passes over flat arenas:

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
  the BERT-Large arena.

Each has its plain PyTorch version beside it (:func:`scale_torch`,
:func:`adam_torch`, :func:`l2norm_sq_torch`, :func:`lamb_stage1_torch`,
:func:`scaled_update_torch`), the CPU path and the kernels' yardstick on the
card. The list APIs (:func:`multi_tensor_scale`, :func:`multi_tensor_adam`,
:func:`multi_tensor_l2norm`, :func:`multi_tensor_lamb`) pack their lists
into a new arena first, as the JAX package does; a list holding one arena
already padded to ``TILE`` is used as it is by the first and third. The
per-tensor sums of squares that LAMB's trust ratios need
(:func:`per_tensor_sumsq`) are plain PyTorch, as the JAX package computes
them in jnp outside any kernel.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.arena import ArenaSpec, flatten, is_arena, unflatten

# elements per Triton program of K5-K8, and per block of K9's walk
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
    impl = resolve_impl(impl, x_flat)
    fn = l2norm_sq_kernel if impl == "kernel" else l2norm_sq_torch
    return fn(x_flat.reshape(-1), scale)


def per_tensor_sumsq(flat: torch.Tensor, spec: ArenaSpec, segment_ids=None,
                     axis_name=None, num_tensors=None) -> torch.Tensor:
    """Per-tensor sum of squares over the arena (``spec.num_tensors``
    values, fp32): one dot product per tensor's slice, plain PyTorch (the
    JAX package computes these in jnp, outside any kernel). ZeRO's sharded
    mode (``segment_ids``/``axis_name``) is not ported."""
    if segment_ids is not None or axis_name is not None or num_tensors is not None:
        raise NotImplementedError(
            "per_tensor_sumsq's sharded mode belongs to ZeRO, not ported yet")
    x = flat.float()
    return torch.stack([
        torch.dot(x[off: off + n], x[off: off + n])
        for off, n in zip(spec.offsets, (math.prod(s) for s in spec.shapes))
    ])


def _segment_coef(values_per_tensor: torch.Tensor, spec: ArenaSpec,
                  segment_ids=None) -> torch.Tensor:
    """A per-tensor value expanded to a per-element arena vector of
    ``spec.padded_total``, 0 on the padding (what the plain scaled update
    multiplies by)."""
    if segment_ids is not None:
        raise NotImplementedError(
            "_segment_coef's segment ids belong to ZeRO, not ported yet")
    sizes = [math.prod(s) for s in spec.shapes]
    pad = spec.padded_total - spec.total
    vals = torch.cat([values_per_tensor,
                      values_per_tensor.new_zeros(1 if pad else 0)])
    reps = torch.tensor(sizes + ([pad] if pad else []),
                        device=values_per_tensor.device)
    return torch.repeat_interleave(vals, reps, output_size=spec.padded_total)


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
    impl = resolve_impl(impl, p_flat)
    fn = lamb_stage1_kernel if impl == "kernel" else lamb_stage1_torch
    u = fn(g_flat, p_flat, m_flat, v_flat, beta1=beta1, beta2=beta2,
           beta3=beta3, bc1=bias_correction1, bc2=bias_correction2, eps=eps,
           weight_decay=weight_decay, clip=clipped_global_grad_norm,
           mode=mode, found_inf=found_inf)
    return u, m_flat, v_flat


# ------------------------------------------------------------------ K8


def scaled_update_torch(p, u, ratio, spec: ArenaSpec, *, found_inf, copy_out):
    """Plain PyTorch version of K8, in place on ``p`` (and ``copy_out``):
    ``p -= coef * u`` with ``coef`` the per-tensor ``ratio`` expanded over
    the arena (:func:`_segment_coef`), held on ``found_inf``."""
    pf = p.float()
    p_new = pf - _segment_coef(ratio.float(), spec) * u.float()
    if found_inf is not None:
        p_new = torch.where(torch.as_tensor(found_inf, device=p.device) != 0,
                            pf, p_new)
    p.copy_(p_new)
    if copy_out is not None:
        copy_out.copy_(p_new)


@functools.lru_cache(maxsize=64)
def _segment_tables(spec: ArenaSpec, device: torch.device):
    """K8's per-block lookup for ``spec``'s arena: for block ``b`` of
    ``_BLOCK`` elements, the tensor holding its first element and the count
    of tensor starts inside it; and the starts themselves, with the
    padding's start (``spec.total``, tensor ``num_tensors``) last. Built on
    the host once per spec and device."""
    starts = np.array(spec.offsets + (spec.total,), dtype=np.int64)
    lo = np.arange(-(-spec.padded_total // _BLOCK), dtype=np.int64) * _BLOCK
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


def scaled_update_kernel(p, u, ratio, spec: ArenaSpec, *, found_inf, copy_out):
    """Launch K8 on flat CUDA arenas of ``spec.padded_total`` elements: fp32
    ``p`` updated in place, fp32 ``u``, ``ratio`` one fp32 value per spec
    tensor, optional ``copy_out`` of any float dtype."""
    n = spec.padded_total
    arenas = (p, u) + (() if copy_out is None else (copy_out,))
    for t in arenas:
        if not t.is_cuda or t.device != p.device or t.ndim != 1 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"K8 takes 1-D contiguous CUDA arenas of the "
                             f"spec's {n} elements on one device; got "
                             f"{tuple(t.shape)} on {t.device}")
    if not (p.dtype == u.dtype == torch.float32):
        raise ValueError(f"K8 updates fp32 p with fp32 u, got {p.dtype}/{u.dtype}")
    if ratio.shape != (spec.num_tensors,) or ratio.device != p.device:
        raise ValueError(f"K8 takes one ratio per spec tensor "
                         f"({spec.num_tensors},) on {p.device}, got "
                         f"{tuple(ratio.shape)} on {ratio.device}")
    triton, kernel = _scaled_update_triton()
    first, span, starts = _segment_tables(spec, p.device)
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
                        impl: Optional[str] = None):
    """``p -= ratio[tensor] * u`` over a flat arena, in place (held on
    ``found_inf``); ``model_copy`` receives the new params in its own dtype
    in the same pass. The JAX function takes the expanded per-element
    coefficient arena; this one takes the per-tensor ``ratio`` and the spec
    (the plain version expands it with :func:`_segment_coef`)."""
    impl = resolve_impl(impl, p_flat)
    fn = scaled_update_kernel if impl == "kernel" else scaled_update_torch
    fn(p_flat, u_flat, ratio, spec, found_inf=found_inf, copy_out=model_copy)
    return p_flat if model_copy is None else (p_flat, model_copy)


# ----------------------------------------------------------------- LAMB


def lamb_flat(gf, pf, mf, vf, spec: ArenaSpec, *, lr, beta1: float = 0.9,
              beta2: float = 0.999, eps: float = 1e-6, step=1,
              bias_correction: bool = True, weight_decay: float = 0.0,
              grad_averaging: bool = True, mode: int = 1,
              global_grad_norm=None, max_grad_norm: float = 1.0,
              use_nvlamb: bool = False, found_inf=None, model_copy_dtype=None,
              model_copy=None, impl: Optional[str] = None,
              _sharded_norms=None):
    """Fused LAMB over flat arenas, IN PLACE on ``pf``, ``mf`` and ``vf``:
    K7 (stage 1), the per-tensor norms of p and u from ``spec``, the trust
    ratios, then K8 (stage 2) with the model copy. ``step`` and
    ``global_grad_norm`` may be device tensors; without ``global_grad_norm``
    the norm is this arena's own (K9). Returns ``(p, m, v)`` or
    ``(p, m, v, model_copy)``. ZeRO's ``_sharded_norms`` is not ported."""
    if _sharded_norms is not None:
        raise NotImplementedError(
            "lamb_flat's sharded norms belong to ZeRO, not ported yet")
    impl = resolve_impl(impl, pf)
    if model_copy is None and model_copy_dtype is not None:
        model_copy = torch.empty(pf.shape, dtype=model_copy_dtype,
                                 device=pf.device)
    bc1, bc2 = _bias_corrections(bias_correction, step, beta1, beta2)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    if global_grad_norm is None:
        global_grad_norm = torch.sqrt(l2norm_sq(gf, impl=impl)[0])
    ggn = _device_scalar(global_grad_norm, pf).reshape(())
    # NaN compares false: a NaN norm leaves the divisor at 1, as in JAX
    clipped = torch.where(ggn > max_grad_norm, ggn / max_grad_norm,
                          torch.ones((), device=pf.device))
    # per-tensor norms of p before stage 2 moves it
    p_norm = torch.sqrt(per_tensor_sumsq(pf, spec))
    u, _, _ = lamb_stage1(gf, pf, mf, vf, beta1=beta1, beta2=beta2,
                          beta3=beta3, bias_correction1=bc1,
                          bias_correction2=bc2, eps=eps,
                          weight_decay=weight_decay,
                          clipped_global_grad_norm=clipped, mode=mode,
                          found_inf=found_inf, impl=impl)
    u_norm = torch.sqrt(per_tensor_sumsq(u, spec))
    lr_t = _device_scalar(lr, pf).reshape(())
    if use_nvlamb or weight_decay != 0.0:
        ratio = torch.where((p_norm != 0.0) & (u_norm != 0.0),
                            lr_t * (p_norm / u_norm), lr_t)
    else:
        ratio = lr_t.expand(p_norm.shape)
    apply_scaled_update(pf, u, ratio.contiguous(), spec, found_inf=found_inf,
                        model_copy=model_copy, impl=impl)
    outs = (pf, mf, vf)
    return outs if model_copy is None else outs + (model_copy,)


def multi_tensor_lamb(grads, params, exp_avgs, exp_avg_sqs, *, lr,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-6, step=1, bias_correction: bool = True,
                      weight_decay: float = 0.0, grad_averaging: bool = True,
                      mode: int = 1, global_grad_norm=None,
                      max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                      found_inf=None, impl: Optional[str] = None,
                      _sharded_norms=None):
    """Fused LAMB over tensor lists; returns new ``(params, m, v)`` lists
    (views of freshly packed arenas — the inputs are not modified). The
    trust ratios are per tensor of the list; ``found_inf`` turns the whole
    update into the identity."""
    gf, spec = flatten(grads)
    pf, _ = flatten(params)
    mf, _ = flatten(exp_avgs)
    vf, _ = flatten(exp_avg_sqs)
    lamb_flat(gf, pf, mf, vf, spec, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              step=step, bias_correction=bias_correction,
              weight_decay=weight_decay, grad_averaging=grad_averaging,
              mode=mode, global_grad_norm=global_grad_norm,
              max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
              found_inf=found_inf, impl=impl, _sharded_norms=_sharded_norms)
    return unflatten(pf, spec), unflatten(mf, spec), unflatten(vf, spec)
