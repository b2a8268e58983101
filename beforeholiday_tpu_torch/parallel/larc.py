"""LARC — layer-wise adaptive rate control, counterpart of
``beforeholiday_tpu/parallel/larc.py`` (the reference's
``apex/parallel/LARC.py``).

LARC conditions each gradient before the inner optimizer's step: the
per-tensor adaptive rate ``tc·‖p‖ / (‖g‖ + wd·‖p‖ + eps)``, clipped to the
group lr when ``clip`` is set, scales the gradient with the decay folded in.
The conditioning is plain PyTorch, one small group of operations a leaf, all
on the device (no value is read back); the inner optimizer's step runs its
kernel.
"""

from __future__ import annotations

import torch

from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_unflatten


class LARC:
    """Wrap a fused optimizer with LARC gradient conditioning.

    ``weight_decay`` lives here, not in the inner optimizer (the reference
    zeroes the group's decay during the wrapped step): an inner optimizer
    with a decay raises ``ValueError``."""

    def __init__(self, inner, *, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8, weight_decay: float = 0.0):
        if getattr(inner, "weight_decay", 0.0):
            raise ValueError(
                "LARC applies weight decay itself; construct the inner "
                "optimizer with weight_decay=0 (ref: apex/parallel/LARC.py:96-100)")
        self.inner = inner
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params):
        return self.inner.init(params)

    def _condition(self, p: torch.Tensor, g: torch.Tensor, lr) -> torch.Tensor:
        """One leaf's gradient, conditioned: where both norms are non-zero,
        ``(g + wd·p)`` times the adaptive rate (over ``lr`` and capped at 1
        with ``clip``); elsewhere ``g`` untouched, so a frozen parameter does
        not decay."""
        p32, g32 = p.float(), g.float()
        p_norm = torch.sqrt((p32 * p32).sum())
        g_norm = torch.sqrt((g32 * g32).sum())
        adaptive = (self.trust_coefficient * p_norm
                    / (g_norm + self.weight_decay * p_norm + self.eps))
        ok = (p_norm != 0.0) & (g_norm != 0.0)
        if self.clip:
            adaptive = torch.clamp(adaptive / lr, max=1.0)
        g_out = torch.where(ok, (g32 + self.weight_decay * p32) * adaptive, g32)
        return g_out.to(g.dtype)

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0,
             lr=None):
        """Unscale, condition each leaf, then the inner step with
        ``grad_scale=1.0``: the reference conditions gradients that are
        already unscaled, so the trust ratio and the folded decay do not see
        the loss scale."""
        eff_lr = self.inner.lr if lr is None else lr
        pleaves = tree_flatten(params)[0]
        gleaves, treedef = tree_flatten(grads)
        conditioned = [self._condition(p, g.float() * grad_scale, eff_lr)
                       for p, g in zip(pleaves, gleaves)]
        return self.inner.step(params, tree_unflatten(treedef, conditioned),
                               state, found_inf=found_inf, grad_scale=1.0, lr=lr)
