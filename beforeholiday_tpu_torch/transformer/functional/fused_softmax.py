"""FusedScaleMaskSoftmax (ref: apex/transformer/functional/fused_softmax.py)
— counterpart of ``beforeholiday_tpu/transformer/functional/fused_softmax.py``.

The module decides per call whether the fused kernels apply (dtype, shape
limits, mask type) with the JAX package's decision surface, and otherwise
runs the eager softmax (``forward_torch_softmax``). That eager branch is the
module's own contract for the inputs its gate keeps off the kernels (fp32
scores, ``scaled_masked_softmax_fusion=False``, a causal shape the gate
refuses), not a fallback: for every input the gate admits, a CUDA tensor
runs kernels K11/K12 (``ops/softmax.py``) or raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from beforeholiday_tpu_torch.ops.softmax import (
    _MASK_VALUE,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from beforeholiday_tpu_torch.transformer.enums import AttnMaskType

# the JAX gate's causal tile: its kernel needs sq a multiple of 128 (K11
# does not, but the gate keeps the JAX package's answers)
_CAUSAL_TILE = 128


class FusedScaleMaskSoftmax:
    """fused scale+mask+softmax with availability heuristics.

    Args mirror the reference module: input dtypes, mask type, fusion toggle,
    optional ``mask_func`` for the eager branch, fp32 softmax option, fixed
    scale. Call with scores (b, np, sq, sk) and optional mask (b, 1, sq, sk).
    """

    def __init__(
        self,
        input_in_fp16: bool = False,
        input_in_bf16: bool = False,
        attn_mask_type: AttnMaskType = AttnMaskType.padding,
        scaled_masked_softmax_fusion: bool = True,
        mask_func: Optional[Callable] = None,
        softmax_in_fp32: bool = True,
        scale: Optional[float] = None,
    ):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active at the same time.")
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """Shape/dtype gate (ref: fused_softmax.py:194-231), with the JAX
        package's answers: half-precision inputs only, 0 < sk <= 16384, and
        causal needs square scores with sq % 128 == 0."""
        if not self.scaled_masked_softmax_fusion:
            return False
        if not self.input_in_float16:
            # the reference only fuses half-precision inputs; fp32 goes eager
            return False
        if sk > 16384 or sk <= 0:
            return False
        if self.attn_mask_type == AttnMaskType.causal:
            return sq == sk and (sq % _CAUSAL_TILE == 0)
        return True

    def __call__(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"expected (b, np, sq, sk) attention scores, got "
                             f"{tuple(x.shape)}")
        b, np_, sq, sk = x.shape
        scale = self.scale if self.scale is not None else 1.0

        if self.is_kernel_available(mask, b, np_, sq, sk):
            return self.forward_fused_softmax(x, mask, scale)
        return self.forward_torch_softmax(x, mask, scale)

    def forward_fused_softmax(self, x, mask, scale):
        """Kernel path (ref: fused_softmax.py:233-259)."""
        if self.attn_mask_type == AttnMaskType.causal:
            # the reference asserts mask is None on the causal kernel path:
            # silently ignoring a padding mask would change numerics by shape
            if mask is not None:
                raise ValueError("causal fused softmax does not accept a mask")
            y = scaled_upper_triang_masked_softmax(
                x.reshape(-1, x.shape[-2], x.shape[-1]), scale)
            return y.reshape(x.shape)
        if mask is not None:
            return scaled_masked_softmax(x, mask, scale)
        return scaled_softmax(x, scale)

    def forward_torch_softmax(self, x, mask, scale):
        """The eager branch (ref: fused_softmax.py:261-274), in plain torch
        ops with the -10000 fill and ``mask_func``."""
        xf = x.float() if self.softmax_in_fp32 else x
        xf = xf * scale
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = x.shape[-2], x.shape[-1]
            causal = torch.ones((sq, sk), dtype=torch.bool, device=x.device).tril()
            xf = torch.where(causal, xf, _MASK_VALUE)
        if mask is not None:
            if self.mask_func is not None:
                xf = self.mask_func(xf, mask)
            else:
                xf = torch.where(mask != 0, _MASK_VALUE, xf)
        probs = torch.softmax(xf, dim=-1)
        if self.softmax_in_fp32 and self.input_in_float16:
            probs = probs.to(x.dtype)
        return probs
