"""Pipeline-parallel forward/backward schedules — counterpart of
``beforeholiday_tpu/transformer/pipeline_parallel/schedules.py`` (ref:
apex/transformer/pipeline_parallel/schedules/).

The JAX package runs one collective tick loop inside ``shard_map`` over the
``pipe`` axis; here each pipe rank is a process and runs the same tick table
eagerly. The pipeline has ``L = V*S`` logical stages (V chunks per rank,
Megatron's interleaving; V = 1 is plain 1F1B). With ``m = g*S + r``
(microbatches in groups of S) and logical stage ``l = v*S + s``:

    rank s runs F(m, v) at tick  t = g*V*S + v*S + s + r
    rank s runs B(m, v) at tick  t = V*S + g*V*S + (V-1-v)*S + (S-1-s) + r

At most one F and one B slot fire per rank and tick, ``M*V + V*S + S - 1``
ticks in all. Every tick ends with the two ring exchanges of
``p2p_communication.send_forward_recv_backward``: activations on the +1
ring, gradients on the -1 ring (chunk v on rank S-1 feeds chunk v+1 on rank
0 through the same ring). Where JAX computes masked values on an idle slot,
a tick here skips the slot and sends zeros; the valid slots run in JAX's
order, so every gradient sums its terms in the same order. The forward slot
of the last logical stage only stores its input: its output feeds no stage,
and the backward slot recomputes it.

The activation store is a ring of ``2*V*S`` stage inputs, independent of M.
The backward slot recomputes the stage forward from the saved input and
differentiates it with ``torch.autograd.grad`` (activation recompute, as
Megatron runs under checkpointing). ``embed_fn`` maps a raw microbatch to
the hidden the rings carry on the first logical stage, ``head_fn`` maps the
last stage's hidden to the loss input; the loss is computed once, in the
backward slot. Each microbatch's loss is divided by M (schedules/common.py
``forward_step``). The loss, and the embed and head gradients (zero off
their stages), are all-reduced over the pipe group (``pp.loss_allreduce``,
``pp.embed_head_allreduce``), so every rank returns them whole.

Eager PyTorch cannot trace the embedding for the rings' shape as
``jax.eval_shape`` does, so with an ``embed_fn`` the caller passes
``tensor_shape`` and ``dtype`` (the reference's names). Parameter trees are
dicts, tuples and lists of tensors; the gradients come back in the params'
dtypes, accumulated in them as JAX accumulates. The double-buffered engine
(``overlap_p2p``), the encoder-decoder schedule and remat policies are not
ported yet and raise.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.spans import span
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_map, tree_unflatten
from beforeholiday_tpu_torch.parallel.parallel_state import PIPE_AXIS, get_group
from beforeholiday_tpu_torch.transformer.pipeline_parallel import p2p_communication

__all__ = [
    "PipelineGrads",
    "activation_ring_depth",
    "analytic_bubble_fraction",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_encoder_decoder",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "get_forward_backward_func",
    "last_schedule_report",
    "phase_counts",
    "schedule_report",
]

_OVERLAP = ("overlap_p2p (the double-buffered, table-driven engine) is not "
            "ported yet: ROADMAP A15")


def _check_remat(remat_policy):
    if remat_policy is not None:
        raise NotImplementedError(
            f"remat_policy={remat_policy!r}: remat policies in the schedules "
            "are not ported yet (ROADMAP A13)")


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size: Optional[int],
    pipeline_model_parallel_size: int,
):
    """Schedule dispatcher (ref: schedules/__init__.py:22-35)."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


def _requires_grad(tree):
    """Fresh leaves of ``tree`` that autograd can differentiate (float
    tensors), detached from any earlier graph."""
    return tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                    tree)


def _diff_leaves(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if t.requires_grad]


def _accumulate(acc, tree, grads) -> None:
    """``acc += grads`` leaf by leaf (``grads`` pairs with ``tree``'s
    differentiable leaves; None is an unused leaf), in the leaves' dtype."""
    it = iter(grads)
    for a, t in zip(tree_flatten(acc)[0], tree_flatten(tree)[0]):
        if t.requires_grad:
            g = next(it)
            if g is not None:
                a.add_(g.to(a.dtype))


def forward_backward_no_pipelining(
    stage_fn: Callable,
    loss_fn: Callable,
    params: Any,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    remat_policy: Optional[str] = None,
    **_,
):
    """Gradient accumulation without stage parallelism (ref:
    schedules/fwd_bwd_no_pipelining.py). ``inputs``/``targets`` lead with the
    microbatch dim (M, ...). Returns (mean loss, param grads)."""
    _check_remat(remat_policy)
    M = inputs.shape[0]
    grads = tree_map(torch.zeros_like, params)
    loss_acc = torch.zeros((), dtype=torch.float32, device=inputs.device)
    for m in range(M):
        p = _requires_grad(params)
        with torch.enable_grad():
            loss = loss_fn(stage_fn(p, inputs[m]), targets[m]) / M
            got = torch.autograd.grad(loss, _diff_leaves(p), allow_unused=True)
        _accumulate(grads, p, got)
        loss_acc = loss_acc + loss.detach().float()
    return loss_acc, grads


def activation_ring_depth(V: int, S: int) -> int:
    """Stage inputs held in flight per rank: 2*V*S, independent of the
    number of microbatches (a microbatch's F→B tick distance is below 2*V*S
    and one F fires per tick, so ``t_F mod 2VS`` never collides)."""
    return 2 * V * S


def analytic_bubble_fraction(num_microbatches: int, pipeline_size: int,
                             virtual_size: int = 1) -> float:
    """The ideal (interleaved) 1F1B bubble fraction ``((p-1)/v) / (m +
    (p-1)/v)`` (Megatron-LM, Section 2.2); at v=1 ``(p-1)/(m+p-1)``."""
    m, p, v = num_microbatches, pipeline_size, virtual_size
    if p <= 1:
        return 0.0
    penalty = (p - 1) / v
    return penalty / (m + penalty)


def phase_counts(num_microbatches: int, pipeline_size: int, rank: int,
                 virtual_size: int = 1) -> Dict[str, int]:
    """One rank's warmup / steady / cooldown microbatch-slot counts (the
    reference's num_warmup_microbatches arithmetic)."""
    m, p, r, v = num_microbatches, pipeline_size, rank, virtual_size
    total = m * v
    if v > 1:
        warmup = min((p - r - 1) * 2 + (v - 1) * p, total)
    else:
        warmup = min(p - r - 1, total)
    return {"rank": r, "warmup": warmup, "steady": total - warmup,
            "cooldown": warmup}


_REPORT_LOCK = threading.Lock()
_LAST_REPORT: Optional[Dict[str, Any]] = None


def schedule_report(num_microbatches: int, pipeline_size: int, *,
                    virtual_size: int = 1, schedule: str = "1f1b",
                    extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """JSON-ready description of one pipelined run's schedule: the config,
    the tick loop's ``total_ticks``, its idle fraction
    (``engine_bubble_fraction``: each rank fills M*V of its F and B slots),
    the ideal ``analytic_bubble_fraction`` and each rank's
    ``phase_counts``."""
    m, p, v = num_microbatches, pipeline_size, virtual_size
    total_ticks = m * v + v * p + p - 1
    report: Dict[str, Any] = {
        "schedule": schedule,
        "num_microbatches": m,
        "pipeline_size": p,
        "virtual_size": v,
        "total_ticks": total_ticks,
        "engine_bubble_fraction": (total_ticks - m * v) / total_ticks,
        "analytic_bubble_fraction": analytic_bubble_fraction(m, p, v),
        "per_rank": [phase_counts(m, p, r, v) for r in range(p)],
    }
    if extra:
        report.update(extra)
    return report


def _record_schedule(report: Dict[str, Any]) -> None:
    global _LAST_REPORT
    with _REPORT_LOCK:
        _LAST_REPORT = report


def last_schedule_report() -> Optional[Dict[str, Any]]:
    """The most recent pipelined run's report (None before any). Recorded
    at every run, where JAX records at every trace."""
    with _REPORT_LOCK:
        return None if _LAST_REPORT is None else dict(_LAST_REPORT)


class PipelineGrads(NamedTuple):
    """Gradients from a pipelined run with embed/head stages."""

    stage: Any
    embed: Any  # None when no embed_fn
    head: Any  # None when no head_fn


def _pipelined_fwd_bwd(stage_fn, loss_fn, chunks, inputs, targets, *, V,
                       axis_name, embed_fn=None, embed_params=None,
                       head_fn=None, head_params=None, tensor_shape=None,
                       dtype=None):
    """The tick-loop engine (see the module docstring). ``chunks``: this
    rank's V chunk trees; chunk v is logical stage v*S + s. Returns (loss,
    per-chunk grad trees, embed grads, head grads)."""
    group = get_group(axis_name)
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    M = inputs.shape[0]
    if targets.shape[0] != M:
        raise ValueError(
            f"microbatch-count mismatch: inputs has {M} microbatches but "
            f"targets has {targets.shape[0]}; both must agree")
    if V > 1 and M % S != 0:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({M}) divisible by "
            f"pipeline size ({S}), as the reference asserts")
    if embed_fn is not None:
        if tensor_shape is None or dtype is None:
            raise ValueError("with an embed_fn, pass tensor_shape and dtype: "
                             "the shape and dtype of the hidden the rings carry")
        hidden_shape, hidden_dtype = tuple(tensor_shape), dtype
    else:
        hidden_shape = tuple(tensor_shape) if tensor_shape is not None else tuple(inputs.shape[1:])
        hidden_dtype = dtype if dtype is not None else inputs.dtype
    total_ticks = M * V + V * S + S - 1
    ring_depth = activation_ring_depth(V, S)
    _record_schedule(schedule_report(
        M, S, virtual_size=V, schedule="interleaved_1f1b" if V > 1 else "1f1b"))
    device = inputs.device

    def decompose_f(t):
        """F slot on this rank at tick t: (valid, m, v, t_F)."""
        u = t - rank
        if u < 0:
            return False, 0, 0, 0
        r, q = u % S, u // S
        v, g = q % V, q // V
        m = g * S + r
        return m < M, m, v, t

    def decompose_b(t):
        """B slot on this rank at tick t: (valid, m, v, t_F of its F)."""
        u = t - V * S - (S - 1 - rank)
        if u < 0:
            return False, 0, 0, 0
        r, q = u % S, u // S
        v, g = (V - 1) - (q % V), q // V
        m = g * S + r
        return m < M, m, v, g * V * S + v * S + rank + r

    def run_embed(ep, raw):
        return (embed_fn(ep, raw) if embed_fn is not None else raw).to(hidden_dtype)

    g_stage = [tree_map(torch.zeros_like, c) for c in chunks]
    g_embed = tree_map(torch.zeros_like, embed_params) if embed_fn is not None else None
    g_head = tree_map(torch.zeros_like, head_params) if head_fn is not None else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    zero = torch.zeros(hidden_shape, dtype=hidden_dtype, device=device)
    act_store: List[Optional[torch.Tensor]] = [None] * ring_depth
    fwd_reg = bwd_reg = zero

    for t in range(total_ticks):
        y = zero
        with span("pp_forward_slot"):
            f_valid, m_f, v_f, t_f = decompose_f(t)
            if f_valid:
                with torch.no_grad():
                    if rank == 0 and v_f == 0:
                        x_in = run_embed(embed_params, inputs[m_f])
                    else:
                        x_in = fwd_reg
                    act_store[t_f % ring_depth] = x_in
                    if not (rank == S - 1 and v_f == V - 1):
                        y = stage_fn(chunks[v_f], x_in).to(hidden_dtype)

        dx = zero
        with span("pp_backward_slot"):
            b_valid, m_b, v_b, t_fb = decompose_b(t)
            if b_valid:
                x = act_store[t_fb % ring_depth].detach().requires_grad_(True)
                act_store[t_fb % ring_depth] = None
                sp = _requires_grad(chunks[v_b])
                last = rank == S - 1 and v_b == V - 1
                with torch.enable_grad():
                    if last:
                        hp = _requires_grad(head_params) if head_fn is not None else None
                        out = stage_fn(sp, x)
                        if head_fn is not None:
                            out = head_fn(hp, out)
                        mb_loss = loss_fn(out, targets[m_b]) / M
                        wrt = _diff_leaves(sp) + (_diff_leaves(hp) if hp is not None else [])
                        got = torch.autograd.grad(mb_loss, wrt + [x], allow_unused=True)
                        loss_acc = loss_acc + mb_loss.detach().float()
                        n_sp = len(_diff_leaves(sp))
                        if hp is not None:
                            _accumulate(g_head, hp, got[n_sp:-1])
                    else:
                        out = stage_fn(sp, x).to(hidden_dtype)
                        got = torch.autograd.grad(out, _diff_leaves(sp) + [x],
                                                  grad_outputs=bwd_reg,
                                                  allow_unused=True)
                _accumulate(g_stage[v_b], sp, got)
                dx = got[-1] if got[-1] is not None else zero
                dx = dx.to(hidden_dtype)
                if embed_fn is not None and rank == 0 and v_b == 0:
                    ep = _requires_grad(embed_params)
                    with torch.enable_grad():
                        emb = run_embed(ep, inputs[m_b])
                        got_e = torch.autograd.grad(emb, _diff_leaves(ep),
                                                    grad_outputs=dx,
                                                    allow_unused=True)
                    _accumulate(g_embed, ep, got_e)

        with span("pp_p2p_rings"):
            fwd_reg, bwd_reg = p2p_communication.send_forward_recv_backward(
                y, dx, axis_name=axis_name)

    # every stage reports the mean loss (the reference broadcasts it); the
    # embed and head grads are zero off their stages, so one all-reduce each
    # makes them whole everywhere
    loss = comms.psum(loss_acc, axis_name, site="pp.loss_allreduce")
    if g_embed is not None:
        g_embed = tree_map(lambda g: comms.psum(g, axis_name,
                                                site="pp.embed_head_allreduce"),
                           g_embed)
    if g_head is not None:
        g_head = tree_map(lambda g: comms.psum(g, axis_name,
                                               site="pp.embed_head_allreduce"),
                          g_head)
    return loss, g_stage, g_embed, g_head


def forward_backward_pipelining_without_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    params: Any,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    axis_name: str = PIPE_AXIS,
    embed_fn: Optional[Callable] = None,
    embed_params: Any = None,
    head_fn: Optional[Callable] = None,
    head_params: Any = None,
    remat_policy: Optional[str] = None,
    overlap_p2p: bool = False,
    tensor_shape=None,
    dtype: Optional[torch.dtype] = None,
):
    """1F1B schedule (ref: fwd_bwd_pipelining_without_interleaving.py:228-488).

    ``params`` is this stage's parameter tree; ``inputs`` (M, *micro) feed
    the first stage (through ``embed_fn`` if given); ``targets`` (M, *tgt)
    are consumed by the last stage (through ``head_fn``). Returns ``(mean
    loss, grads)``: this stage's grad tree without embed/head, else
    ``PipelineGrads(stage, embed, head)``. The loss is whole on every
    stage."""
    _check_remat(remat_policy)
    if overlap_p2p:
        raise NotImplementedError(_OVERLAP)
    loss, g_stage, g_embed, g_head = _pipelined_fwd_bwd(
        stage_fn, loss_fn, [params], inputs, targets, V=1, axis_name=axis_name,
        embed_fn=embed_fn, embed_params=embed_params, head_fn=head_fn,
        head_params=head_params, tensor_shape=tensor_shape, dtype=dtype)
    if embed_fn is None and head_fn is None:
        return loss, g_stage[0]
    return loss, PipelineGrads(g_stage[0], g_embed, g_head)


def forward_backward_pipelining_encoder_decoder(*args, **kwargs):
    """The encoder-decoder schedule is not ported yet (ROADMAP A15)."""
    raise NotImplementedError(
        "forward_backward_pipelining_encoder_decoder is not ported yet: "
        "ROADMAP A15")


def forward_backward_pipelining_with_interleaving(
    stage_fn: Callable,
    loss_fn: Callable,
    chunk_params: Any,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    virtual_pipeline_model_parallel_size: int,
    axis_name: str = PIPE_AXIS,
    embed_fn: Optional[Callable] = None,
    embed_params: Any = None,
    head_fn: Optional[Callable] = None,
    head_params: Any = None,
    remat_policy: Optional[str] = None,
    overlap_p2p: bool = False,
    tensor_shape=None,
    dtype: Optional[torch.dtype] = None,
):
    """Interleaved virtual-pipeline schedule (ref:
    fwd_bwd_pipelining_with_interleaving.py:26-415).

    ``chunk_params`` leaves lead with the V (virtual chunk) dim: chunk v on
    rank s is logical stage ``v*S + s``. The number of microbatches must be
    a multiple of the pipe size. Returns ``(loss, grads)`` with grads
    leading with V (or ``PipelineGrads``)."""
    _check_remat(remat_policy)
    if overlap_p2p:
        raise NotImplementedError(_OVERLAP)
    V = virtual_pipeline_model_parallel_size
    bad = [tuple(leaf.shape) for leaf in tree_flatten(chunk_params)[0]
           if leaf.shape[0] != V]
    if bad:
        raise ValueError(f"chunk_params leaves must lead with V={V}, got {bad[0]}")
    chunks = [tree_map(lambda leaf, v=v: leaf[v], chunk_params) for v in range(V)]
    loss, g_stage, g_embed, g_head = _pipelined_fwd_bwd(
        stage_fn, loss_fn, chunks, inputs, targets, V=V, axis_name=axis_name,
        embed_fn=embed_fn, embed_params=embed_params, head_fn=head_fn,
        head_params=head_params, tensor_shape=tensor_shape, dtype=dtype)
    leaves = [tree_flatten(g)[0] for g in g_stage]
    stacked = tree_unflatten(tree_flatten(chunk_params)[1],
                             [torch.stack(ls) for ls in zip(*leaves)])
    if embed_fn is None and head_fn is None:
        return loss, stacked
    return loss, PipelineGrads(stacked, g_embed, g_head)
