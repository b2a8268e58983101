"""Expert-parallel dispatch and combine over the ledgered ``all_to_all`` —
counterpart of ``beforeholiday_tpu/moe/dispatch.py``.

GShard's expert parallelism: each rank routes its local tokens among all
``E`` experts, places them in an ``(E, capacity, D)`` slot tensor, and one
``all_to_all`` over the ``expert`` group re-shards it from expert-major to
rank-major, so every rank holds its ``E / ep`` experts' slots from all
``ep`` peers (``(E / ep, ep * capacity, D)``). The grouped FFN runs, and the
inverse exchange brings each token's expert outputs home for the weighted
combine. Both hops go through ``monitor.comms.all_to_all_differentiable``,
booked at ``moe.dispatch`` and ``moe.combine`` (their backward exchanges at
``.bwd``). With ``hierarchical=True`` over a ``("slice", "intra")`` pair the
joint exchange runs as a slice stage (booked on the DCN tier) and an intra
stage (ICI), with a transpose that restores the joint slice-major chunk
order: pure data movement, bitwise the joint collective.

The slots are moved by index, never by one-hot contractions: the JAX
package's ``tec,td->ecd`` dispatch and ``tec,ecd->etd`` combine gather are
0/1 contractions with at most one nonzero term an output, exact copies, so
a gather gives their values without the ``(T, E, C)`` tensors (2.68 GB
each, fp32, at a flagship group). A dropped (token, choice) is copied to a
sentinel slot that is cut off, and reads a zero row on the way back, so the
dispatch reads no device value on the host. The final combine keeps
the oracle's shape, a ``(T, E) x (E, T, D)`` weighted sum in fp32
(:func:`_combine`, shared with :func:`dense_oracle`), which is why at
sufficient capacity :func:`moe_layer`'s forward equals :func:`dense_oracle`
wherever the batched GEMMs are row-stable.

Remat: the dispatched and combined activations carry the
``remat.moe_dispatch`` / ``remat.moe_combine`` tags, so ``"save_boundaries"``
saves the two exchange boundaries and recomputes the expert FFN between
them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from beforeholiday_tpu_torch.moe.experts import expert_ffn
from beforeholiday_tpu_torch.moe.router import (
    MoEConfig,
    dense_gates,
    route_compact,
    router_logits,
)
from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.spans import span
from beforeholiday_tpu_torch.parallel.bucketing import static_axis_size
from beforeholiday_tpu_torch.parallel.parallel_state import hierarchical_axes
from beforeholiday_tpu_torch.remat.policies import (
    TAG_MOE_COMBINE,
    TAG_MOE_DISPATCH,
    checkpoint_name,
)

__all__ = [
    "dense_oracle",
    "expert_all_to_all",
    "moe_layer",
]

_F32 = torch.float32


def _tiers(axis_name: Any, hierarchical: bool) -> Optional[Tuple[str, str]]:
    """The ``(slow, fast)`` axis pair when ``hierarchical`` is on, else None
    (the joint collective)."""
    if not hierarchical:
        return None
    pair = hierarchical_axes(axis_name)
    if pair is None:
        raise ValueError("hierarchical=True needs a (slice, intra) expert-axis "
                         f"pair, got {axis_name!r}")
    return pair


def expert_all_to_all(x: torch.Tensor, axis_name: Any, *, site: str,
                      inverse: bool = False,
                      hierarchical: bool = False) -> torch.Tensor:
    """The expert-parallel reshard ``(E, C, D) -> (E / ep, ep * C, D)``
    (``inverse=True`` undoes it): a tiled exchange splitting the expert dim
    and joining the received capacity chunks in rank order.

    Hierarchical form: the slice stage, then the intra stage, each on
    ``1 / tier size`` of the expert dim, with the received chunks' nesting
    transposed from ``(intra, slice, C)`` back to the joint exchange's
    ``(slice, intra, C)``."""
    a2a = comms.all_to_all_differentiable
    tiers = _tiers(axis_name, hierarchical)
    if tiers is None:
        return a2a(x, axis_name, *((1, 0) if inverse else (0, 1)), site=site)
    slow, fast = tiers
    S, I = static_axis_size(slow), static_axis_size(fast)
    if not inverse:
        E, C, D = x.shape
        z = a2a(x, slow, 0, 1, site=site + ".slice")
        z = a2a(z, fast, 0, 1, site=site + ".intra")
        El = E // (S * I)
        return z.reshape(El, I, S, C, D).transpose(1, 2).reshape(El, S * I * C, D)
    El, PC, D = x.shape
    C = PC // (S * I)
    z = x.reshape(El, S, I, C, D).transpose(1, 2).reshape(El, I * S * C, D)
    z = a2a(z, fast, 1, 0, site=site + ".intra")
    return a2a(z, slow, 1, 0, site=site + ".slice")


def _combine(gates: torch.Tensor, y_tok: torch.Tensor) -> torch.Tensor:
    """The final weighted sum ``(T, E) x (E, T, D) -> (T, D)`` in fp32, one
    spelling for :func:`moe_layer` and :func:`dense_oracle`: elementwise
    products and a sum over the expert dim, passes over memory (the
    contraction over E = 4 is no work for a GEMM)."""
    return (gates.t()[:, :, None] * y_tok).sum(0)


def _aux(routing) -> Dict[str, torch.Tensor]:
    return {"moe_aux_loss": routing.aux_loss, "moe_z_loss": routing.z_loss,
            "moe_drop_fraction": routing.drop_fraction}


def moe_layer(x: torch.Tensor, w_router: torch.Tensor, expert_params: dict,
              cfg: MoEConfig, *, expert_axis: Any = None,
              tensor_axis: Optional[str] = None, hierarchical: bool = False,
              capacity: Optional[int] = None,
              emulate_tensor: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One MoE FFN layer over one routing group.

    ``x``: ``(T, D)``, the tokens local to this rank. With ``expert_axis``
    (inside an entered mesh) ``expert_params`` holds this rank's ``E / ep``
    experts and the dispatch/combine exchange pair runs; with
    ``expert_axis=None`` every expert computes here. ``tensor_axis`` and
    ``emulate_tensor`` go to :func:`~.experts.expert_ffn`.

    Returns ``(y, aux)``: ``y (T, D)`` in x's dtype (an all-zero row for a
    dropped token: the caller's residual add passes it through), ``aux``
    this group's ``moe_aux_loss`` / ``moe_z_loss`` / ``moe_drop_fraction``,
    keyed as ``TrainMonitor`` reads them."""
    T, D = x.shape
    E = cfg.n_experts
    if capacity is None:
        capacity = cfg.capacity(T)
    if expert_axis is not None:
        ep = static_axis_size(expert_axis)
        if E % ep != 0:
            raise ValueError(f"n_experts ({E}) must divide evenly over the "
                             f"expert-parallel world ({ep})")

    # trace spans (host-side markers, cheap when no profiler runs) split the
    # layer's device time into the router, the dispatch, the experts and the
    # combine
    with span("moe_layer"):
        with span("moe_router"):
            r = route_compact(router_logits(x, w_router), cfg, capacity)
        with span("moe_dispatch"):
            EC = E * capacity
            # each (choice, token)'s flat slot, or the sentinel row EC when dropped
            dest = torch.where(r.keep, r.expert * capacity + r.slot,
                               torch.full_like(r.slot, EC))
            # the tokens copied into their slots (a slot takes at most one
            # token; only the discarded sentinel takes several), so the
            # backward gathers each slot's gradient once
            xd = x.new_zeros(EC + 1, D)
            for k in range(dest.shape[0]):
                xd = xd.index_copy_(0, dest[k], x)
            xd = xd[:EC].view(E, capacity, D)
            if expert_axis is not None:
                xd = expert_all_to_all(xd, expert_axis, site="moe.dispatch",
                                       hierarchical=hierarchical)
            xd = checkpoint_name(xd, TAG_MOE_DISPATCH)
        with span("moe_experts"):
            y = expert_ffn(expert_params, xd, tensor_axis=tensor_axis,
                           emulate_tensor=emulate_tensor)
        with span("moe_combine"):
            if expert_axis is not None:
                y = expert_all_to_all(y, expert_axis, site="moe.combine",
                                      inverse=True, hierarchical=hierarchical)
            y = checkpoint_name(y, TAG_MOE_COMBINE)
            # combine in two steps, as JAX does, so the final sum has the
            # oracle's shape: each (choice, token)'s slot (an exact copy, or
            # zero for a dropped one) copied to its (expert, token) place of
            # a zero (E, T, D), then the gate-weighted sum over experts
            slot = torch.where(r.keep, dest, torch.zeros_like(dest)).reshape(-1)
            rows = y.reshape(EC, D).index_select(0, slot)
            rows = torch.where(r.keep.reshape(-1, 1), rows, 0.0).to(_F32)
            place = (r.expert * T + torch.arange(T, device=x.device)).reshape(-1)
            y_tok = torch.zeros(E * T, D, dtype=_F32, device=x.device).index_copy_(
                0, place, rows).view(E, T, D)
            gates = torch.zeros(T, E, dtype=_F32, device=x.device).scatter_add(
                1, r.expert.t(), (r.gate * r.keep).t())  # (T, E) kept gates
            out = _combine(gates, y_tok).to(x.dtype)
    return out, _aux(r)


def dense_oracle(x: torch.Tensor, w_router: torch.Tensor, expert_params: dict,
                 cfg: MoEConfig, *,
                 tensor_parallel: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The no-drop dense reference: every expert computes every token, then
    each token's top-k gates (no capacity, no dropping) weight the outputs.
    ``tensor_parallel`` spells the FFN as a ``tp``-way Megatron split
    computes it (``d_ff`` column chunks, row partial products summed in rank
    order). ``aux`` reports ``moe_drop_fraction = 0``."""
    T, D = x.shape
    E = cfg.n_experts
    gates, aux_loss, z_loss = dense_gates(router_logits(x, w_router), cfg)
    y = expert_ffn(expert_params, x[None].expand(E, T, D),
                   emulate_tensor=tensor_parallel, quantized=False)
    out = _combine(gates, y.to(_F32))
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_drop_fraction": torch.zeros((), dtype=_F32, device=x.device)}
    return out.to(x.dtype), aux
