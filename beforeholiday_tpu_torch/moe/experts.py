"""Grouped expert FFN — counterpart of ``beforeholiday_tpu/moe/experts.py``.

The E expert MLPs are stacked along a leading ``experts`` axis (GShard's
einsum formulation) and applied to the dispatched ``(E, C, D)`` activations
as one batched GEMM a projection (``torch.bmm``: cuBLAS on the card), with
no Python loop over experts and no ragged shapes. The stacked tree (``wi
(E, D, F)``, ``bi (E, F)``, ``wo (E, F, D)``, ``bo (E, D)``) is four leaves
the flat-arena optimizers step like any dense weight.

Rounding follows the JAX package and ``ops/dense.py`` (C1): a bf16 or fp16
product is accumulated in fp32 and rounded once to the input dtype (on the
card one ``torch.bmm(..., out_dtype=torch.float32)``; on the CPU the
operands widened to fp32 first, which is exact); the bias is added after, in
the activation dtype, as JAX adds it. The backward keeps the half-precision
products, as the dense layers do.

Tensor parallelism lives inside the expert (Megatron expert-tensor
parallelism): ``wi`` column-sharded over ``d_ff``, ``wo`` row-sharded, one
ledgered psum over the tensor group after the second GEMM (site
``moe.experts.row_parallel``), whose backward is the identity; the input's
gradient is summed over the group in the backward (site
``moe.experts.column_parallel.bwd``), which JAX's ``shard_map`` leaves to
its caller. Under ``quantized_compute()`` both GEMMs run
``ops.quantized.quantized_matmul`` expert by expert (O6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops._autocast import quantized_enabled
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.quantized import quantized_matmul

__all__ = [
    "expert_ffn",
    "expert_param_specs",
    "init_experts",
]

_F32 = torch.float32
_HALF = (torch.bfloat16, torch.float16)


def init_experts(generator: torch.Generator, n_experts: int, d_model: int,
                 d_ff: int, *, init_std: float = 0.02,
                 out_std: Optional[float] = None, device=None) -> dict:
    """Stacked expert-FFN parameters (fp32), drawn from the reference's
    distributions on ``generator``'s device and moved to ``device`` (the
    card unless the caller asks for another device; raises with no card and
    no ``device``). ``out_std`` scales the output projection (the
    surrounding model's depth-scaled std; default ``init_std``)."""
    o_std = init_std if out_std is None else out_std
    E, D, Fd = n_experts, d_model, d_ff
    device = resolve_device(device)

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(device)

    return {
        "wi": normal((E, D, Fd), init_std),
        "bi": torch.zeros((E, Fd), dtype=_F32, device=device),
        "wo": normal((E, Fd, D), o_std),
        "bo": torch.zeros((E, D), dtype=_F32, device=device),
    }


def expert_param_specs(*, expert_axis=None, tensor_axis=None) -> dict:
    """Which axis shards each dim of the stacked tree (the JAX package's
    ``PartitionSpec``s as tuples): experts over ``expert_axis`` (the leading
    dim), Megatron column/row sharding over ``tensor_axis`` on ``d_ff``.
    Either axis may be None (replicated)."""
    e, t = expert_axis, tensor_axis
    return {"wi": (e, None, t), "bi": (e, t), "wo": (e, t, None), "bo": (e, None)}


class _GroupedHalf32(torch.autograd.Function):
    """``x @ w`` batched over experts for half-precision operands, with an
    fp32 result. The card's half x half -> fp32 batched GEMM has no
    derivative in PyTorch, so the backward is written here."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.bmm(x, w, out_dtype=_F32)
        return torch.bmm(x.to(_F32), w.to(_F32))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = dy.to(x.dtype)  # a half-precision value: the output's cotangent
        dx = torch.bmm(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = torch.bmm(x.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   quantized: Optional[bool] = None) -> torch.Tensor:
    """``(E, C, D) x (E, D, F) -> (E, C, F)`` in x's dtype, accumulated in
    fp32 and rounded once. ``quantized`` (default: inside
    ``quantized_compute()``) takes the O6 fp8 GEMM per expert; its
    just-in-time activation scale is an amax over one expert's slab, so
    results agree across layouts only to fp8 noise."""
    if quantized is None:
        quantized = quantized_enabled()
    if quantized:
        w = w.to(x.dtype)
        return torch.stack([quantized_matmul(x[e], w[e])
                            for e in range(x.shape[0])]).to(x.dtype)
    w = w.to(x.dtype)
    if x.dtype in _HALF:
        return _GroupedHalf32.apply(x, w).to(x.dtype)
    return torch.bmm(x, w)


class _RowParallelSum(torch.autograd.Function):
    """Megatron's g region: psum over the tensor group, identity backward."""

    @staticmethod
    def forward(ctx, y, axis):
        return comms.psum(y, axis, site="moe.experts.row_parallel")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _ColumnInput(torch.autograd.Function):
    """Megatron's f region: identity forward, psum of the input's gradient
    over the tensor group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return comms.psum(dx, ctx.axis, site="moe.experts.column_parallel.bwd"), None


def _bias(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return b.to(x.dtype)[:, None, :]


def expert_ffn(params: dict, x: torch.Tensor, *,
               tensor_axis: Optional[str] = None,
               emulate_tensor: int = 1,
               quantized: Optional[bool] = None) -> torch.Tensor:
    """Every (local) expert's gelu MLP on its capacity batch. ``x``:
    ``(E_local, C, D)``.

    With ``tensor_axis`` (inside an entered mesh) ``params`` holds this
    rank's ``d_ff`` shard: column-parallel first GEMM, row-parallel second,
    one psum. ``emulate_tensor=tp`` computes what a ``tp``-way split
    computes, on one process: ``d_ff`` column chunks through gelu, the
    row-chunk partial products summed in rank order. It excludes
    ``tensor_axis``. ``quantized`` goes to :func:`grouped_matmul`. The
    tanh-approximate gelu is ``jax.nn.gelu``'s default."""
    if emulate_tensor > 1:
        if tensor_axis is not None:
            raise ValueError("emulate_tensor is the SINGLE-device spelling; "
                             "pass one of tensor_axis / emulate_tensor")
        Fd = params["wi"].shape[-1]
        if Fd % emulate_tensor != 0:
            raise ValueError(f"d_ff ({Fd}) must divide the emulated tensor "
                             f"world ({emulate_tensor})")
        chunk = Fd // emulate_tensor
        y = None
        for r in range(emulate_tensor):
            sl = slice(r * chunk, (r + 1) * chunk)
            h = grouped_matmul(x, params["wi"][:, :, sl], quantized=quantized) \
                + _bias(params["bi"][:, sl], x)
            part = grouped_matmul(F.gelu(h, approximate="tanh"),
                                  params["wo"][:, sl, :], quantized=quantized)
            y = part if y is None else y + part
        return y + _bias(params["bo"], x)
    if tensor_axis is not None:
        x = _ColumnInput.apply(x, tensor_axis)
    h = grouped_matmul(x, params["wi"], quantized=quantized) + _bias(params["bi"], x)
    y = grouped_matmul(F.gelu(h, approximate="tanh"), params["wo"], quantized=quantized)
    if tensor_axis is not None:
        y = _RowParallelSum.apply(y, tensor_axis)
    # row-parallel convention: the bias once, after the reduction
    return y + _bias(params["bo"], x)
