"""Vocab-parallel cross entropy — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/cross_entropy.py`` (ref:
apex/transformer/tensor_parallel/cross_entropy.py:23-103).

The reference's ``_VocabParallelCrossEntropy`` as a
``torch.autograd.Function``: the local max and an all-reduce MAX, the local
sum of exponentials and an all-reduce SUM, then the target logit, which only
its owning rank contributes, in a third all-reduce (label smoothing adds a
fourth, the sum of the log-probabilities). The backward is ``softmax -
onehot`` from saved tensors, with the smoothed form where asked.
``save_softmax=False`` keeps the logits and the row statistics ``(xmax,
sum_ex)`` in place of the fp32 local softmax and rebuilds it in the backward
from the same exponentials, bitwise. Every collective books site
``tp.vocab_cross_entropy``.
"""

from __future__ import annotations

import torch

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS
from beforeholiday_tpu_torch.transformer.tensor_parallel.layers import vocab_range

__all__ = ["vocab_parallel_cross_entropy"]

_SITE = "tp.vocab_cross_entropy"


def _fwd_math(logits, target, vocab_size, axis_name):
    """(loss, softmax_local, (in_range, local_idx), (xmax, sum_ex))."""
    x = logits.float()
    xmax = comms.pmax(x.amax(dim=-1), axis_name, site=_SITE)
    x = x - xmax[..., None]
    ex = torch.exp(x)
    sum_ex = comms.psum(ex.sum(dim=-1), axis_name, site=_SITE)
    start, local = vocab_range(vocab_size, axis_name)
    in_range = (target >= start) & (target < start + local)
    local_idx = torch.where(in_range, target - start, 0).long()
    tgt = x.gather(-1, local_idx[..., None])[..., 0]
    tgt = comms.psum(torch.where(in_range, tgt, 0.0), axis_name, site=_SITE)
    loss = torch.log(sum_ex) - tgt
    return loss, ex / sum_ex[..., None], (in_range, local_idx), (xmax, sum_ex)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, vocab_size, label_smoothing, axis_name,
                save_softmax):
        loss, softmax_local, (in_range, local_idx), (xmax, sum_ex) = _fwd_math(
            logits, target, vocab_size, axis_name)
        if label_smoothing > 0:
            log_probs = torch.log(torch.clamp(softmax_local, min=1e-30))
            mean_log = comms.psum(log_probs.sum(dim=-1), axis_name,
                                  site=_SITE) / vocab_size
            loss = (1.0 - label_smoothing) * loss - label_smoothing * mean_log
        ctx.vocab_size, ctx.label_smoothing = vocab_size, label_smoothing
        ctx.save_softmax, ctx.grad_dtype = save_softmax, logits.dtype
        if save_softmax:
            ctx.save_for_backward(softmax_local, in_range, local_idx)
        else:
            ctx.save_for_backward(logits, xmax, sum_ex, in_range, local_idx)
        return loss

    @staticmethod
    def backward(ctx, dy):
        if ctx.save_softmax:
            softmax_local, in_range, local_idx = ctx.saved_tensors
        else:
            logits, xmax, sum_ex, in_range, local_idx = ctx.saved_tensors
            # the forward's exp on the same inputs: the same softmax, bitwise
            softmax_local = torch.exp(logits.float() - xmax[..., None]) / sum_ex[..., None]
        onehot = torch.zeros_like(softmax_local).scatter_(
            -1, local_idx[..., None], in_range[..., None].float())
        s = ctx.label_smoothing
        if s > 0:
            # d/dx [(1-s)*nll - s*mean_log] = (1-s)*(p - onehot) + s*(p - 1/V)
            grad = ((1.0 - s) * (softmax_local - onehot)
                    + s * (softmax_local - 1.0 / ctx.vocab_size))
        else:
            grad = softmax_local - onehot
        return ((grad * dy[..., None]).to(ctx.grad_dtype), None, None, None,
                None, None)


def vocab_parallel_cross_entropy(
    logits: torch.Tensor,  # (..., vocab/world) local shard
    target: torch.Tensor,  # (...,) int global vocab ids
    vocab_size: int,
    label_smoothing: float = 0.0,
    axis_name: str = TENSOR_AXIS,
    *,
    save_softmax: bool = True,
) -> torch.Tensor:
    """Per-token cross entropy over vocab-sharded logits; returns (...,)
    fp32. ``save_softmax=False`` saves the row statistics in place of the
    local softmax and recomputes it in the backward (same values, smaller
    saved tensors)."""
    return _VocabParallelCrossEntropy.apply(
        logits, target, int(vocab_size), float(label_smoothing), axis_name,
        bool(save_softmax))
