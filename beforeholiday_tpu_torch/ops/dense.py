"""Dense and MLP blocks — counterpart of ``beforeholiday_tpu/ops/dense.py``.

The JAX package leaves these products to XLA outside any Pallas kernel, so
here they are library GEMMs (cuBLAS on the card).

Rounding follows the JAX contract: the product of bf16 (or fp16) operands
is kept in fp32 (``preferred_element_type``), the bias is added in fp32 and
the sum is rounded once to the input dtype. On the card the product and
the bias are one cuBLAS bf16 x bf16 -> fp32 GEMM (``torch.addmm(bias, x, w,
out_dtype=torch.float32)``, or ``torch.mm`` without a bias); on the CPU the
operands are widened to fp32 first, which is exact, since a bf16 x bf16
(or fp16 x fp16) product fits in fp32. The backward keeps the
half-precision products (the output's cotangent is a bf16 or fp16 value,
as in JAX; at a large loss scale an fp16 cotangent may overflow to inf,
which the unscale's overflow flag catches).

The three public functions carry the ``half_function`` tag, as in the JAX
package: inside an O1/O4 autocast scope their floating arguments are cast to
the scope's dtype first. Inside an O6 ``quantized_compute`` scope each
product runs through ``ops.quantized.quantized_matmul`` (fp8 operands,
fp32 result), the weight taken in its own dtype as JAX takes it; the bias is
still added in fp32 and the sum rounded once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops._autocast import half_function, quantized_enabled
from beforeholiday_tpu_torch.ops.quantized import quantized_matmul


class _HalfDense32(torch.autograd.Function):
    """``x2 @ w + bias32`` for 2-D half-precision operands (bf16 or fp16)
    and an optional fp32 bias, with an fp32 result. The card's half x half
    -> fp32 GEMM has no derivative in PyTorch, so the backward is written
    here."""

    @staticmethod
    def forward(ctx, x2, w, bias32):
        ctx.save_for_backward(x2, w)
        ctx.has_bias = bias32 is not None
        if not x2.is_cuda:
            y = x2.float() @ w.float()
            return y if bias32 is None else y + bias32
        if bias32 is None:
            return torch.mm(x2, w, out_dtype=torch.float32)
        return torch.addmm(bias32, x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        g = dy.to(x2.dtype)  # a half-precision value: the output's cotangent
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ g if ctx.needs_input_grad[1] else None
        db = dy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def _linear32(x, weight, bias):
    """Product with an fp32 result, bias added in fp32; returns fp32."""
    b32 = None if bias is None else bias.float()
    if quantized_enabled():
        y = quantized_matmul(x, weight)
        return y if b32 is None else y + b32
    w = weight.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        y = torch.matmul(x, w)
        return y if b32 is None else y + b32
    y = _HalfDense32.apply(x.reshape(-1, x.shape[-1]), w, b32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


@half_function
def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEMM + bias. x: (..., in); weight: (in, out); bias: (out,). Output in
    x's dtype."""
    return _linear32(x, weight, bias).to(x.dtype)


@half_function
def fused_dense_gelu_dense(x: torch.Tensor, weight1: torch.Tensor,
                           bias1: torch.Tensor, weight2: torch.Tensor,
                           bias2: torch.Tensor) -> torch.Tensor:
    """GEMM + bias + tanh-approximate GELU + GEMM + bias."""
    h = F.gelu(_linear32(x, weight1, bias1), approximate="tanh")
    return _linear32(h.to(x.dtype), weight2, bias2).to(x.dtype)


@half_function
def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor], activation: str = "relu") -> torch.Tensor:
    """Whole-MLP chain; the activation ('none' | 'relu' | 'sigmoid') runs
    between layers but not after the last."""
    if len(weights) != len(biases):
        raise ValueError("weights and biases must pair up")
    acts = {"none": lambda h: h, "relu": torch.relu, "sigmoid": torch.sigmoid}
    if activation not in acts:
        raise ValueError(
            f"activation must be one of {sorted(acts)}, got {activation!r}"
        )
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = _linear32(h, w, b)
        if i + 1 < len(weights):
            h = acts[activation](h)
        h = h.to(x.dtype)
    return h
