"""Sequence-parallel-aware norms — counterpart of
``beforeholiday_tpu/transformer/layers/layer_norm.py`` (ref:
apex/transformer/layers/layer_norm.py:33-99).

Under sequence parallelism each tensor rank normalizes only its sequence
shard, so the scale and bias gradients are partial sums; the reference tags
the parameters and its gradient pass all-reduces them over the tensor
group. Here the norm's parameters pass through an identity whose backward
all-reduces their gradients (both in one collective, site
``sp.norm_param_grads``); dx stays local. The norms are
``ops.normalization``'s, so K1 forward and K3 backward on the card. The JAX
package's custom VJP calls ``lax.psum`` directly, which its ledger does not
see; here the all-reduce is booked like every other collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops.normalization import fused_layer_norm, fused_rms_norm
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS

__all__ = ["sp_fused_layer_norm", "sp_fused_rms_norm"]


class _ParamGradsAllReduce(torch.autograd.Function):
    """Identity on the norm's parameters; their gradients summed over the
    tensor group in one collective."""

    @staticmethod
    def forward(ctx, axis_name, *params):
        ctx.axis_name = axis_name
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *comms.psum(list(grads), ctx.axis_name,
                                  site="sp.norm_param_grads"))


def sp_fused_layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
    sequence_parallel: bool = False,
    axis_name: str = TENSOR_AXIS,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """FusedLayerNorm whose parameter gradients are all-reduced over the
    tensor group under sequence parallelism (the functional form of the
    reference's ``sequence_parallel_enabled`` tag)."""
    if sequence_parallel:
        scale, bias = _ParamGradsAllReduce.apply(axis_name, scale, bias)
    return fused_layer_norm(x, scale, bias, eps=eps, impl=impl)


def sp_fused_rms_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    *,
    eps: float = 1e-5,
    sequence_parallel: bool = False,
    axis_name: str = TENSOR_AXIS,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """FusedRMSNorm, its scale's gradient all-reduced under sequence
    parallelism."""
    if sequence_parallel:
        (scale,) = _ParamGradsAllReduce.apply(axis_name, scale)
    return fused_rms_norm(x, scale, eps=eps, impl=impl)
