"""Dense and MLP blocks — counterpart of ``beforeholiday_tpu/ops/dense.py``.

The JAX package leaves these products to XLA outside any Pallas kernel, so
here they are library GEMMs through ``torch.matmul`` (cuBLAS on the card).

Rounding differs from the JAX contract in one place: JAX multiplies with an
fp32 accumulator, adds the bias in fp32 and rounds once to the input dtype.
A bf16 ``torch.matmul`` rounds its product to bf16 before the bias add, so a
bf16 output can differ by one more bf16 rounding (relative 2**-8 of the
output); fp32 inputs round identically.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _linear32(x, weight, bias):
    """Product in x's dtype, bias epilogue in fp32; returns fp32."""
    y = torch.matmul(x, weight.to(x.dtype)).float()
    if bias is not None:
        y = y + bias.float()
    return y


def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEMM + bias. x: (..., in); weight: (in, out); bias: (out,). Output in
    x's dtype."""
    return _linear32(x, weight, bias).to(x.dtype)


def fused_dense_gelu_dense(x: torch.Tensor, weight1: torch.Tensor,
                           bias1: torch.Tensor, weight2: torch.Tensor,
                           bias2: torch.Tensor) -> torch.Tensor:
    """GEMM + bias + tanh-approximate GELU + GEMM + bias."""
    h = F.gelu(_linear32(x, weight1, bias1), approximate="tanh")
    return _linear32(h.to(x.dtype), weight2, bias2).to(x.dtype)


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
