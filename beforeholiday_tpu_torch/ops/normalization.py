"""Fused LayerNorm / RMSNorm on kernels K1 (forward) and K3 (backward), both
CUDA C++ (``csrc/layer_norm_fwd.cu``, ``csrc/layer_norm_bwd.cu``).

K1 replaces ``beforeholiday_tpu/ops/normalization.py:55`` ``_ln_fwd_kernel``
(launched at ``:112``). It computes the same function: per row the mean and
variance (or the mean square for RMSNorm) in fp32 whatever the storage dtype,
then ``xhat * w + b`` written in the dtype the caller chose. K3 replaces
``_ln_bwd_kernel`` (``:69``, launched by ``_ln_bwd_pallas`` at ``:134``).
Each source states its bound and design. :func:`ln_fwd_geometry` and
:func:`ln_bwd_geometry` size their persistent grids, the team of warps that
owns a row and the stages of their rings from the card's SM count.

The forward and backward are the ``torch.library`` custom ops
``beforeholiday::layer_norm_fwd`` and ``layer_norm_bwd`` where autograd
records the call or a dispatch mode is active (``_dispatch.call_op``): a
selective remat policy can then save K1's output (``remat.TAG_NORM_OUT``)
and skip it in the recompute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from beforeholiday_tpu_torch import _build
from beforeholiday_tpu_torch.ops._autocast import float_function
from beforeholiday_tpu_torch.ops._dispatch import call_op, resolve_impl, sm_count
from beforeholiday_tpu_torch.remat.policies import TAG_NORM_OUT, tag_op

# the dtypes K1 and K3 take, by K3's C interface code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# widest row K1 and K3 stage in shared memory
_MAX_HIDDEN = 16384
# shared memory a block of an H100 may use, and what the SM keeps of each
# resident block for itself
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED = 1024


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


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


# K1's blocks: at most 8 warps; a team of 1-8 of them owns a row, each lane
# units of 8 consecutive elements, at most _LN_FWD_UNITS units a lane (twice
# that above hidden 8192, at one block an SM); gamma and beta staged as fp32
_LN_FWD_VEC = 8
_LN_FWD_UNITS = 4
_LN_FWD_RED_BYTES = 2 * 8 * 4  # two reductions' cross-warp sums
_LN_FWD_KEYS = ("team_warps", "nu", "teams", "stages", "blocks", "blocks_per_sm", "smem")


def ln_fwd_geometry(rows: int, hidden: int, x_size: int, y_size: int,
                    sms: int) -> dict:
    """K1's launch for ``rows`` x ``hidden`` with x of ``x_size`` and y of
    ``y_size`` bytes an element on a card of ``sms`` SMs: ``team_warps`` (the
    warps that own a row) and ``nu`` (units of 8 elements a lane), from the
    width alone, so that a row's bits never depend on the call; ``teams`` a
    block (fewer for few rows, so that they spread over SMs), ``stages`` of
    the cp.async ring, the persistent ``blocks`` at ``blocks_per_sm`` and the
    dynamic shared memory ``smem`` (the cross-warp sums of wider teams, fp32
    gamma and beta, the ring). The most blocks an SM that still leave two
    stages win. y leaves from registers, so its size changes no part of the
    plan. Raises where no plan fits."""
    return dict(zip(_LN_FWD_KEYS, _ln_fwd_plan(rows, hidden, x_size, y_size, sms)))


@functools.lru_cache(maxsize=1024)
def _ln_fwd_plan(rows, hidden, x_size, y_size, sms):
    if not 0 < hidden <= _MAX_HIDDEN:
        raise ValueError(f"K1 takes hidden widths 1..{_MAX_HIDDEN}, got {hidden}")
    units = -(-hidden // _LN_FWD_VEC)
    team_warps = next((t for t in (1, 2, 4, 8) if units <= 32 * t * _LN_FWD_UNITS), 8)
    nu = _LN_FWD_UNITS if units <= 32 * team_warps * _LN_FWD_UNITS else 2 * _LN_FWD_UNITS
    row_bytes = units * _LN_FWD_VEC * x_size
    head = (_LN_FWD_RED_BYTES if team_warps > 1 else 0) + 2 * 4 * units * _LN_FWD_VEC
    for per_sm in ((4, 2, 1) if nu == _LN_FWD_UNITS else (1,)):
        budget = min(_SMEM_PER_BLOCK, _SMEM_PER_SM // per_sm - _SMEM_RESERVED) - head
        teams = max(1, min(8 // team_warps, -(-rows // (sms * per_sm))))
        while teams > 1 and budget // (teams * row_bytes) < 2:
            teams //= 2
        stages = min(3, budget // (teams * row_bytes))
        if stages >= 2:
            break
    if stages < 1:
        raise ValueError(f"K1 has no shared-memory plan for hidden {hidden}")
    blocks = max(1, min(sms * per_sm, -(-rows // teams)))
    return team_warps, nu, teams, stages, blocks, per_sm, head + stages * teams * row_bytes


@functools.cache
def _ln_fwd_lib():
    fn = _build.load("layer_norm_fwd").ln_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, i, i, i, i, i, i,
                   ctypes.c_float, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def ln_fwd_kernel(x2d, w, b, eps: float, rms: bool, out_dtype):
    """Launch K1 on CUDA tensors. Checks device, dtype, shape and layout and
    raises on anything the kernel does not take."""
    if x2d.ndim != 2 or not x2d.is_cuda:
        raise ValueError(f"K1 takes a 2-D CUDA tensor, got {tuple(x2d.shape)} "
                         f"on {x2d.device}")
    rows, hidden = x2d.shape
    if not 0 < hidden <= _MAX_HIDDEN:
        raise ValueError(f"hidden {hidden} is outside K1's widths 1..{_MAX_HIDDEN}")
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
    dev = x2d.device
    y = torch.empty((rows, hidden), dtype=out_dtype, device=dev)
    if rows:
        team_warps, nu, teams, stages, blocks, _, smem = _ln_fwd_plan(
            rows, hidden, x2d.element_size(), y.element_size(), sm_count(dev.index))
        fn = _ln_fwd_lib()
        with torch.cuda.device(dev):
            rc = fn(x2d.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                    y.data_ptr(), rows, hidden, x2d.stride(0), _KERNEL_DTYPES[x2d.dtype],
                    _KERNEL_DTYPES[w.dtype], _KERNEL_DTYPES[(w if b is None else b).dtype],
                    _KERNEL_DTYPES[out_dtype], int(rms), int(b is not None), float(eps),
                    team_warps, nu, teams, stages, blocks, smem,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1 (layer_norm_fwd) launch failed with CUDA error {rc}")
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


# K3's blocks: 8 warps; a team of 1-8 of them owns a row, each lane 4
# consecutive elements a unit, at most _LN_UNITS units a lane (twice that
# above hidden 8192, at one block an SM)
_LN_WARPS = 8
_LN_UNITS = 8
_LN_RED_BYTES = 2 * _LN_WARPS * 4 * 4  # two passes' cross-warp sums


def ln_bwd_geometry(rows: int, hidden: int, x_size: int, dy_size: int,
                    sms: int) -> dict:
    """K3's launch for ``rows`` x ``hidden`` with x and dy of ``x_size`` and
    ``dy_size`` bytes an element on a card of ``sms`` SMs:
    ``team_warps`` (the warps that own a row), ``nu`` (units of 4 elements a
    lane), ``blocks`` (persistent, also the partial rows of dgamma/dbeta),
    ``stages`` of the cp.async ring and the dynamic shared memory ``smem``."""
    if not 0 < hidden <= _MAX_HIDDEN:
        raise ValueError(f"K3 takes hidden widths 1..{_MAX_HIDDEN}, got {hidden}")
    units = -(-hidden // 4)
    team_warps = next((t for t in (1, 2, 4, 8) if units <= 32 * t * _LN_UNITS), 8)
    nu = _LN_UNITS if units <= 32 * team_warps * _LN_UNITS else 2 * _LN_UNITS
    teams = _LN_WARPS // team_warps
    per_sm = 2 if nu == _LN_UNITS else 1
    row_bytes = _up16(hidden * x_size) + _up16(hidden * dy_size)
    head = _up16(4 * hidden) + _LN_RED_BYTES  # fp32 w, then the reductions
    acc = teams * 2 * 4 * (-(-hidden // 4) * 4)  # the teams' dgamma/dbeta rows
    budget = min(_SMEM_PER_BLOCK, _SMEM_PER_SM // per_sm - _SMEM_RESERVED) - head
    stages = min(3, budget // (teams * row_bytes))
    if stages < 1 or acc > budget:
        raise ValueError(f"K3 has no shared-memory plan for hidden {hidden}")
    smem = head + max(stages * teams * row_bytes, acc)
    blocks = max(1, min(sms * per_sm, -(-rows // teams)))
    return dict(team_warps=team_warps, nu=nu, teams=teams, stages=stages,
                blocks=blocks, smem=smem)


@functools.cache
def _ln_bwd_lib():
    fn = _build.load("layer_norm_bwd").ln_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, i, i, ll, ll, i, i, i, i, i,
                   ctypes.c_float, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _aligned_rows(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` is a whole number of 16-byte chunks on a
    16-byte boundary: K3 then stages it by cp.async."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0 and (t.stride(0) * size) % 16 == 0
            and (t.shape[1] * size) % 16 == 0)


def ln_bwd_kernel(x2d, w, dy, eps: float, rms: bool, has_bias: bool = True):
    """Launch K3 on CUDA tensors: ``(dx in x's dtype, dw, db in w's dtype)``,
    ``db`` None without a bias. Checks device, dtype, shape and layout and
    raises on anything the kernel does not take."""
    if x2d.ndim != 2:
        raise ValueError(f"K3 takes a 2-D x, got {tuple(x2d.shape)}")
    rows, hidden = x2d.shape
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"hidden {hidden} exceeds K3's widest row {_MAX_HIDDEN}")
    for dt in (x2d.dtype, dy.dtype, w.dtype):
        if dt not in _KERNEL_DTYPES:
            raise ValueError(f"K3 does not take dtype {dt}")
    if not x2d.is_cuda:
        raise ValueError(f"K3 takes CUDA tensors, got x on {x2d.device}")
    if dy.shape != x2d.shape or dy.device != x2d.device:
        raise ValueError(f"K3 dy must match x {tuple(x2d.shape)} on "
                         f"{x2d.device}, got {tuple(dy.shape)} on {dy.device}")
    if w.device != x2d.device or w.shape != (hidden,):
        raise ValueError(f"K3 weight must be ({hidden},) on {x2d.device}")
    if x2d.stride(1) != 1 or dy.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("K3 needs unit-stride rows and a contiguous weight")
    dev = x2d.device
    geo = ln_bwd_geometry(rows, hidden, x2d.element_size(), dy.element_size(),
                          sm_count(dev.index or 0))
    dx = torch.empty((rows, hidden), dtype=x2d.dtype, device=dev)
    dw = torch.empty((hidden,), dtype=w.dtype, device=dev)
    db = torch.empty((hidden,), dtype=w.dtype, device=dev) if has_bias else None
    partial = torch.empty((2 if has_bias else 1) * geo["blocks"] * hidden,
                          dtype=torch.float32, device=dev)
    fn = _ln_bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x2d.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), db.data_ptr() if has_bias else None,
                partial.data_ptr(), rows, hidden, x2d.stride(0), dy.stride(0),
                _KERNEL_DTYPES[x2d.dtype], _KERNEL_DTYPES[dy.dtype],
                _KERNEL_DTYPES[w.dtype],
                int(rms), int(has_bias), float(eps), geo["team_warps"],
                geo["nu"], geo["stages"], geo["blocks"], geo["smem"],
                int(_aligned_rows(x2d) and _aligned_rows(dy)), stream)
    if rc != 0:
        raise RuntimeError(f"K3 (layer_norm_bwd) launch failed with CUDA error {rc}")
    ln_bwd_kernel.launches += 1
    return dx, dw, db


ln_bwd_kernel.launches = 0


def _ln_fwd(x2d: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            eps: float, rms: bool, out_dtype: torch.dtype,
            impl: str) -> torch.Tensor:
    fn = ln_fwd_kernel if impl == "kernel" else ln_fwd_torch
    return fn(x2d, w, b, eps, rms, out_dtype)


_ln_fwd_op = torch.library.custom_op("beforeholiday::layer_norm_fwd",
                                     mutates_args=())(_ln_fwd)


@_ln_fwd_op.register_fake
def _(x2d, w, b, eps, rms, out_dtype, impl):
    return x2d.new_empty(x2d.shape, dtype=out_dtype)


def _ln_bwd(x2d: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float,
            rms: bool, has_bias: bool,
            impl: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)``; ``db`` is empty without a bias (an op returns
    tensors only)."""
    if impl == "kernel":
        dx, dw, db = ln_bwd_kernel(x2d, w, dy.contiguous(), eps, rms, has_bias)
    else:
        dx, dw, db = ln_bwd_torch(x2d, w, dy, eps, rms)
        dw = dw.to(w.dtype)
        db = db.to(w.dtype) if has_bias else None
    return dx, dw, db if has_bias else w.new_empty(0)


_ln_bwd_op = torch.library.custom_op("beforeholiday::layer_norm_bwd",
                                     mutates_args=())(_ln_bwd)


@_ln_bwd_op.register_fake
def _(x2d, w, dy, eps, rms, has_bias, impl):
    return (torch.empty_like(x2d), torch.empty_like(w),
            torch.empty_like(w) if has_bias else w.new_empty(0))


def _ln_setup(ctx, inputs, output):
    x2d, w, b, eps, rms, _, impl = inputs
    ctx.save_for_backward(x2d, w)
    ctx.eps, ctx.rms, ctx.impl, ctx.has_bias = eps, rms, impl, b is not None


def _ln_backward(ctx, dy):
    x2d, w = ctx.saved_tensors
    dx, dw, db = call_op(_ln_bwd_op, _ln_bwd, x2d, w, dy, ctx.eps, ctx.rms,
                         ctx.has_bias, ctx.impl)
    return dx, dw, db if ctx.has_bias else None, None, None, None, None


_ln_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup)
# the norm output is the value a save_boundaries policy keeps (JAX tags it
# at ops/normalization.py:294)
tag_op(torch.ops.beforeholiday.layer_norm_fwd, TAG_NORM_OUT)


def _norm_impl(x, weight, bias, eps, rms, out_dtype, impl):
    impl = resolve_impl(impl, x, op="layer_norm")
    hidden = x.shape[-1]
    if weight.shape != (hidden,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({hidden},)")
    if bias is not None and bias.shape != (hidden,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({hidden},)")
    x2d = x.reshape(-1, hidden)
    y = call_op(_ln_fwd_op, _ln_fwd, x2d, weight, bias, float(eps), rms,
                out_dtype, impl)
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
