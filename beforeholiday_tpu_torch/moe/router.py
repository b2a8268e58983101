"""Top-k router with capacity-factor token dropping — counterpart of
``beforeholiday_tpu/moe/router.py`` (the GShard/Switch recipe).

Each token goes to its top-1 or top-2 experts under a static per-expert
``capacity``; tokens past an expert's capacity are dropped from the expert
computation and pass through the residual unchanged. Slot assignment is
first-choice-first: first choices claim slots in token order (a
``cumsum``), kept first choices fill a ``[0, kept_1)`` prefix per expert and
second choices start after it, so the decision is a function of the logits
alone. Routing one group is independent of the expert-parallel world.

Two auxiliary losses ride along, under ``TrainMonitor``'s keys: the Switch
load-balance loss ``E * sum_e f_e * P_e`` (``f_e`` the fraction of first
choices on expert ``e``, a constant under autograd; ``P_e`` the mean router
probability, which carries the gradient) and the ST-MoE z-loss
``mean(logsumexp(logits)^2)``.

:func:`route` returns the JAX package's dense ``(T, E, capacity)``
``dispatch`` and ``combine`` tensors, its public API. ``moe_layer`` uses the
compact form behind it, :func:`route_compact`: for each (choice, token) the
expert, the slot, the keep flag and the gate. At a flagship group (16,384
tokens, 4 experts, capacity 10,240) a dense fp32 ``(T, E, C)`` tensor is
2.68 GB; the compact form is four ``(top_k, T)`` vectors. Nothing here reads
a device value on the host: capacity is a Python int from static shapes,
every decision a comparison on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Tuple

import torch

__all__ = [
    "MoEConfig",
    "RouterDecision",
    "dense_gates",
    "route",
    "router_logits",
]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Static MoE hyperparameters."""

    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 1e-2   # load-balance loss weight (Switch uses 1e-2)
    z_weight: float = 1e-3     # router z-loss weight (ST-MoE uses 1e-3)

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")
        if self.n_experts < 2:
            raise ValueError(f"need >= 2 experts, got {self.n_experts}")

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert slot count for a ``n_tokens`` routing group:
        ``ceil(top_k * n_tokens / n_experts * capacity_factor)``, at least
        1."""
        return max(1, math.ceil(
            self.top_k * n_tokens * self.capacity_factor / self.n_experts))


class RouterDecision(NamedTuple):
    """One group's routing outcome: ``dispatch`` the 0/1 ``(T, E,
    capacity)`` slot assignment, ``combine`` the gates on the same slots
    (all-zero rows: dropped tokens), both fp32; the group's two auxiliary
    losses and the fraction of (token, choice) assignments dropped."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    drop_fraction: torch.Tensor


class CompactRouting(NamedTuple):
    """:func:`route_compact`'s decision, one row a choice: ``expert``,
    ``slot`` (int64) and ``keep`` (bool) are ``(top_k, T)``; ``gate`` the
    normalized gates, fp32, whether kept or not."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    drop_fraction: torch.Tensor


class _RouterLogits(torch.autograd.Function):
    """``x @ w`` in fp32 with an fp32 backward. Two half-precision operands
    on the card take one cuBLAS half x half -> fp32 GEMM: their products are
    exact in fp32, as the widened operands' are, and accumulate in fp32 (an
    fp32 GEMM with 4 columns runs at a fraction of the card's rate)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype == w.dtype and x.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(x, w, out_dtype=_F32)
        return x.to(_F32) @ w.to(_F32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = (dy @ w.to(_F32).t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (x.to(_F32).t() @ dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """``(T, D) @ (D, E) -> (T, E)`` router logits in fp32 whatever the
    activation dtype: the argmax and the softmax normalizer are
    precision-sensitive in a way the FFN body is not."""
    return _RouterLogits.apply(x, w_router)


def _topk(logits: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                     torch.Tensor, torch.Tensor]:
    """The shared top-k core: per choice ``(expert (T,), one-hot mask (T,
    E), gate (T,))``, and the two auxiliary losses. :func:`route_compact`
    and :func:`dense_gates` both use it, so the two paths cannot drift."""
    T, E = logits.shape
    logits = logits.to(_F32)
    probs = torch.softmax(logits, dim=-1)
    # router z-loss: mean squared softmax normalizer (ST-MoE eq. 5)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    ids = torch.arange(E, device=logits.device)

    e1 = probs.argmax(dim=-1)
    mask1 = (e1[:, None] == ids).to(_F32)  # one_hot without a host check
    g1 = probs.gather(-1, e1[:, None])[:, 0]
    # load-balance loss over first choices (Switch eq. 4): f carries no
    # gradient, p does
    f = mask1.mean(dim=0)
    p = probs.mean(dim=0)
    aux_loss = E * (f * p).sum()
    if cfg.top_k == 1:
        return [(e1, mask1, g1)], aux_loss, z_loss

    e2 = (probs * (1.0 - mask1)).argmax(dim=-1)
    mask2 = (e2[:, None] == ids).to(_F32)
    g2 = probs.gather(-1, e2[:, None])[:, 0]
    # GShard normalizes the two gates to sum to 1 over the chosen pair
    denom = torch.clamp_min(g1 + g2, 1e-9)
    return [(e1, mask1, g1 / denom), (e2, mask2, g2 / denom)], aux_loss, z_loss


def route_compact(logits: torch.Tensor, cfg: MoEConfig,
                  capacity: int) -> CompactRouting:
    """Route one group, ``(T, E)`` logits, into the compact form of
    :class:`CompactRouting`: the slots of :func:`route`'s ``dispatch``
    without the ``(T, E, capacity)`` tensor."""
    T, E = logits.shape
    choices, aux_loss, z_loss = _topk(logits, cfg)
    used = torch.zeros(E, dtype=_F32, device=logits.device)  # kept so far
    kept_total = torch.zeros((), dtype=_F32, device=logits.device)
    experts, slots, keeps, gates = [], [], [], []
    for e, mask, gate in choices:
        # 0-based slot of each (token, chosen expert): the position among
        # this choice's tokens for that expert, after the slots earlier
        # choices filled
        # the scan along a contiguous dim: (E, T), each expert's row
        pos = torch.cumsum(mask.t().contiguous(), dim=1).t() - mask + used[None, :]
        keep = mask * (pos < capacity)
        used = used + keep.sum(dim=0)
        kept_total = kept_total + keep.sum()
        experts.append(e)
        slots.append((pos * keep).sum(dim=-1).to(torch.int64))
        keeps.append(keep.sum(dim=-1) > 0)
        gates.append(gate)
    drop_fraction = 1.0 - kept_total / float(cfg.top_k * T)
    return CompactRouting(torch.stack(experts), torch.stack(slots),
                          torch.stack(keeps), torch.stack(gates), aux_loss,
                          z_loss, drop_fraction)


def route(logits: torch.Tensor, cfg: MoEConfig, capacity: int) -> RouterDecision:
    """Route one group: ``(T, E)`` logits -> :class:`RouterDecision` with
    static per-expert ``capacity`` (first choice first, ``cumsum``
    positions). The dense tensors are scattered from
    :func:`route_compact`'s slots: each (token, expert, slot) gets at most
    one 1 and its gate."""
    T, E = logits.shape
    r = route_compact(logits, cfg, capacity)
    flat = (r.expert * capacity + r.slot).t()          # (T, top_k)
    kept = r.keep.t().to(_F32)
    dispatch = torch.zeros(T, E * capacity, dtype=_F32, device=logits.device)
    combine = torch.zeros_like(dispatch)
    # a dropped choice adds an exact 0 at its (expert, 0) slot
    dispatch = dispatch.scatter_add(1, flat, kept)
    combine = combine.scatter_add(1, flat, kept * r.gate.t())
    return RouterDecision(dispatch.view(T, E, capacity),
                          combine.view(T, E, capacity), r.aux_loss, r.z_loss,
                          r.drop_fraction)


def dense_gates(logits: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """No-drop dense gating: the ``(T, E)`` matrix of each token's top-k
    gates at its chosen experts, no capacity, and :func:`route`'s
    ``(aux_loss, z_loss)``. At sufficient capacity ``route(...).combine.sum
    (-1)`` equals it: the dense oracle's gate surface."""
    choices, aux_loss, z_loss = _topk(logits, cfg)
    gates = torch.zeros(logits.shape, dtype=_F32, device=logits.device)
    for _, mask, gate in choices:
        gates = gates + mask * gate[:, None]
    return gates, aux_loss, z_loss
