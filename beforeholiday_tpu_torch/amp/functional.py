"""amp.functional — counterpart of ``beforeholiday_tpu/amp/functional.py``:
the functions of the reference's O1 lists, pre-wrapped with their cast tags,
for a model that calls them directly (the package's fused ops are tagged at
their definitions):

* FP32_FUNCS (``float_function``: fp32 inside an autocast scope): softmax,
  log_softmax, exp, log, log1p, pow, logsumexp, softplus, erf,
  cross_entropy, nll_loss, mse_loss, l1_loss,
  binary_cross_entropy_with_logits;
* CASTS (``promote_function``: the widest floating input): add, sub, mul,
  div, matmul;
* BANNED: ``binary_cross_entropy`` raises inside an fp16 scope; use
  ``binary_cross_entropy_with_logits``.

Outside an autocast scope every wrapper is its plain PyTorch function. The
signatures are the JAX package's (``axis``, not ``dim``).
"""

from __future__ import annotations

import torch

from beforeholiday_tpu_torch.ops._autocast import (
    banned_function,
    float_function,
    promote_function,
)

__all__ = [
    "softmax", "log_softmax", "exp", "log", "log1p", "pow", "logsumexp",
    "softplus", "erf", "cross_entropy", "nll_loss", "mse_loss", "l1_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "add", "sub", "mul", "div", "matmul",
]

# -- FP32_FUNCS ----------------------------------------------------------------


@float_function
def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


@float_function
def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


exp = float_function(torch.exp)
log = float_function(torch.log)
log1p = float_function(torch.log1p)
pow = float_function(torch.pow)  # noqa: A001 - the reference list's name
erf = float_function(torch.erf)


@float_function
def logsumexp(a, axis=None, keepdims: bool = False):
    """``log(sum(exp(a)))`` over ``axis`` (every axis when None)."""
    dims = tuple(range(a.ndim)) if axis is None else axis
    return torch.logsumexp(a, dim=dims, keepdim=keepdims)


@float_function
def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


@float_function
def cross_entropy(logits, labels, *, smoothing: float = 0.0):
    """Mean label-smoothing CE over (N, C) logits (F.cross_entropy)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if smoothing:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    return nll.mean()


@float_function
def nll_loss(logp, labels):
    """Mean NLL over (N, C) log-probabilities (F.nll_loss)."""
    return -logp.gather(-1, labels[:, None]).mean()


@float_function
def mse_loss(pred, target):
    return ((pred - target) ** 2).mean()


@float_function
def l1_loss(pred, target):
    return (pred - target).abs().mean()


# -- BANNED ----------------------------------------------------------------------


def _bce(probs, targets):
    eps = 1e-12
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


binary_cross_entropy = banned_function(
    _bce,
    "binary_cross_entropy",
    "fp16 probabilities saturate; use binary_cross_entropy_with_logits "
    "(the reference raises the same way)",
)


@float_function
def binary_cross_entropy_with_logits(logits, targets):
    """The amp-safe replacement the error above points to."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# -- CASTS: promote to the widest floating input -----------------------------------

add = promote_function(torch.add)
sub = promote_function(torch.sub)
mul = promote_function(torch.mul)
div = promote_function(torch.div)


@promote_function
def matmul(a, b):
    """``a @ b`` with jnp's promotion of mixed inputs, outside a scope too
    (``torch.matmul`` refuses them; the elementwise ops above promote)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))
