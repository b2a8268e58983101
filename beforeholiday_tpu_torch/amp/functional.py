"""amp.functional — counterpart of ``beforeholiday_tpu/amp/functional.py``,
the part the GPT training loss uses: the log-sum-exp and cross entropy of
the FP32_FUNCS list, tagged with :func:`float_function` (inert until the
O1/O4 autocast scope is ported, so each is its plain PyTorch function)."""

from __future__ import annotations

import torch

from beforeholiday_tpu_torch.ops._autocast import float_function

__all__ = ["logsumexp", "cross_entropy"]

logsumexp = float_function(torch.logsumexp)


@float_function
def cross_entropy(logits, labels, *, smoothing: float = 0.0):
    """Mean label-smoothing CE over (N, C) logits (F.cross_entropy)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if smoothing:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    return nll.mean()
