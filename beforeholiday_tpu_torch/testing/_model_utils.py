"""Shared helpers for the in-repo test models — counterpart of
``beforeholiday_tpu/testing/_model_utils.py`` (the mesh-constraint helpers
have no single-device counterpart and are not ported)."""

from __future__ import annotations

from typing import Optional

import torch

from beforeholiday_tpu_torch.ops import fused_layer_norm


def layernorm(x, scale, bias, impl: Optional[str] = None):
    """Fused LN; fp32 gamma/beta may meet bf16 activations uncast — the
    kernel computes in fp32 internally."""
    return fused_layer_norm(x, scale, bias, impl=impl)


def vocab_head_matmul(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits ``x @ embedding.T`` returned UNROUNDED in fp32.

    JAX multiplies in x's compute dtype with an fp32 accumulator. Widening
    both low-precision operands to fp32 first is exact, so the fp32 product
    here gives the same sums without the bf16 rounding of the output that a
    bf16 ``torch.matmul`` would add (which flips greedy argmax ties)."""
    w = embedding.to(x.dtype).float()
    return torch.matmul(x.float(), w.t())
