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
dtypes, accumulated in them as JAX accumulates. ``remat_policy`` wraps the
stage function with ``remat.apply`` in every engine, as JAX does: the
backward slot's recompute then runs under the policy, and ``"full"``
recomputes the stage's internals once more inside the slot's backward.

``overlap_p2p=True`` runs the double-buffered engine: the rings carry the
PREVIOUS tick's outputs, posted before the tick computes and waited on
after it, so wire and compute overlap. A hop then takes two ticks, the
closed forms no longer hold, and the slots come from host tables
(:func:`_overlap_tables`, JAX's greedy list schedule, verbatim); received
values land in ring buffers of the tables' depths.
:func:`forward_backward_pipelining_encoder_decoder` is JAX's T5-style 1F1B:
the rings carry a ``(hidden, memory)`` pair, ranks before the split rank are
encoder stages, and the encoder's output becomes the decoders' memory.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.spans import span
from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_map, tree_unflatten
from beforeholiday_tpu_torch.parallel.parallel_state import PIPE_AXIS, get_group
from beforeholiday_tpu_torch.remat.policies import apply as remat_apply
from beforeholiday_tpu_torch.transformer.pipeline_parallel import p2p_communication

__all__ = [
    "EncDecPipelineGrads",
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
    stage_fn = remat_apply(stage_fn, remat_policy)
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


class EncDecPipelineGrads(NamedTuple):
    """Gradients from an encoder-decoder pipelined run."""

    stage: Any
    enc_embed: Any
    dec_embed: Any
    head: Any


def _check_microbatches(M, counts, V, S):
    for name, n in counts.items():
        if n != M:
            raise ValueError(
                f"microbatch-count mismatch: inputs has {M} microbatches but "
                f"{name} has {n}; all must agree")
    if V > 1 and M % S != 0:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({M}) divisible by "
            f"pipeline size ({S}), as the reference asserts")


def _hidden(embed_fn, inputs, tensor_shape, dtype):
    """The shape and dtype of the hidden the rings carry."""
    if embed_fn is not None:
        if tensor_shape is None or dtype is None:
            raise ValueError("with an embed_fn, pass tensor_shape and dtype: "
                             "the shape and dtype of the hidden the rings carry")
        return tuple(tensor_shape), dtype
    shape = tuple(tensor_shape) if tensor_shape is not None else tuple(inputs.shape[1:])
    return shape, dtype if dtype is not None else inputs.dtype


def _psum_trees(axis_name, *trees):
    """Each tree's leaves all-reduced over the pipe group (None stays None):
    the embed and head grads are zero off their stages, so one all-reduce
    makes them whole everywhere."""
    return [None if t is None else tree_map(
        lambda g: comms.psum(g, axis_name, site="pp.embed_head_allreduce"), t)
        for t in trees]


class _Slots:
    """The slot bodies the 1F1B engines share: a stage's forward, and its
    backward by recompute from the saved input (the loss on the last
    logical stage, the embedding's gradient on the first)."""

    def __init__(self, stage_fn, loss_fn, chunks, inputs, targets, M, hidden_dtype,
                 embed_fn, embed_params, head_fn, head_params):
        self.stage_fn, self.loss_fn, self.chunks = stage_fn, loss_fn, chunks
        self.inputs, self.targets, self.M = inputs, targets, M
        self.dtype = hidden_dtype
        self.embed_fn, self.embed_params = embed_fn, embed_params
        self.head_fn, self.head_params = head_fn, head_params
        self.g_stage = [tree_map(torch.zeros_like, c) for c in chunks]
        self.g_embed = (tree_map(torch.zeros_like, embed_params)
                        if embed_fn is not None else None)
        self.g_head = (tree_map(torch.zeros_like, head_params)
                       if head_fn is not None else None)
        self.loss = torch.zeros((), dtype=torch.float32, device=inputs.device)

    def embed(self, ep, m):
        raw = self.inputs[m]
        return (self.embed_fn(ep, raw) if self.embed_fn is not None else raw).to(self.dtype)

    def forward(self, v, x_in):
        with torch.no_grad():
            return self.stage_fn(self.chunks[v], x_in).to(self.dtype)

    def backward(self, v, m, x_saved, ct, last: bool, first: bool):
        """Accumulate chunk v's gradients for microbatch m (and the loss
        and head grads when ``last``, the embed grads when ``first``);
        returns the input's cotangent in the hidden dtype, or None when
        nothing reaches it."""
        x = x_saved.detach().requires_grad_(True)
        sp = _requires_grad(self.chunks[v])
        with torch.enable_grad():
            if last:
                hp = (_requires_grad(self.head_params)
                      if self.head_fn is not None else None)
                out = self.stage_fn(sp, x)
                if hp is not None:
                    out = self.head_fn(hp, out)
                mb_loss = self.loss_fn(out, self.targets[m]) / self.M
                wrt = _diff_leaves(sp) + (_diff_leaves(hp) if hp is not None else [])
                got = torch.autograd.grad(mb_loss, wrt + [x], allow_unused=True)
                self.loss = self.loss + mb_loss.detach().float()
                if hp is not None:
                    _accumulate(self.g_head, hp, got[len(_diff_leaves(sp)):-1])
            else:
                out = self.stage_fn(sp, x).to(self.dtype)
                got = torch.autograd.grad(out, _diff_leaves(sp) + [x],
                                          grad_outputs=ct, allow_unused=True)
        _accumulate(self.g_stage[v], sp, got)
        dx = None if got[-1] is None else got[-1].to(self.dtype)
        if first and self.embed_fn is not None and dx is not None:
            ep = _requires_grad(self.embed_params)
            with torch.enable_grad():
                got_e = torch.autograd.grad(self.embed(ep, m), _diff_leaves(ep),
                                            grad_outputs=dx, allow_unused=True)
            _accumulate(self.g_embed, ep, got_e)
        return dx

    def finish(self, axis_name):
        # every stage reports the mean loss (the reference broadcasts it)
        loss = comms.psum(self.loss, axis_name, site="pp.loss_allreduce")
        g_embed, g_head = _psum_trees(axis_name, self.g_embed, self.g_head)
        return loss, self.g_stage, g_embed, g_head


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
    _check_microbatches(M, {"targets": targets.shape[0]}, V, S)
    hidden_shape, hidden_dtype = _hidden(embed_fn, inputs, tensor_shape, dtype)
    total_ticks = M * V + V * S + S - 1
    ring_depth = activation_ring_depth(V, S)
    _record_schedule(schedule_report(
        M, S, virtual_size=V, schedule="interleaved_1f1b" if V > 1 else "1f1b"))
    slots = _Slots(stage_fn, loss_fn, chunks, inputs, targets, M, hidden_dtype,
                   embed_fn, embed_params, head_fn, head_params)

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

    zero = torch.zeros(hidden_shape, dtype=hidden_dtype, device=inputs.device)
    act_store: List[Optional[torch.Tensor]] = [None] * ring_depth
    fwd_reg = bwd_reg = zero

    for t in range(total_ticks):
        y = zero
        with span("pp_forward_slot"):
            f_valid, m_f, v_f, t_f = decompose_f(t)
            if f_valid:
                with torch.no_grad():
                    x_in = (slots.embed(embed_params, m_f) if rank == 0 and v_f == 0
                            else fwd_reg)
                act_store[t_f % ring_depth] = x_in
                if not (rank == S - 1 and v_f == V - 1):
                    y = slots.forward(v_f, x_in)

        dx = zero
        with span("pp_backward_slot"):
            b_valid, m_b, v_b, t_fb = decompose_b(t)
            if b_valid:
                x = act_store[t_fb % ring_depth]
                act_store[t_fb % ring_depth] = None
                got = slots.backward(v_b, m_b, x, bwd_reg,
                                     last=rank == S - 1 and v_b == V - 1,
                                     first=rank == 0 and v_b == 0)
                dx = zero if got is None else got

        with span("pp_p2p_rings"):
            fwd_reg, bwd_reg = p2p_communication.send_forward_recv_backward(
                y, dx, axis_name=axis_name)
    return slots.finish(axis_name)


# --- the double-buffered (overlap_p2p) engine --------------------------------


@functools.lru_cache(maxsize=None)
def _overlap_tables(M: int, S: int, V: int) -> Dict[str, Any]:
    """JAX's greedy list schedule of the distance-2 pipeline event DAG
    (``beforeholiday_tpu/transformer/pipeline_parallel/schedules.py``
    ``_overlap_tables``), host integers, the same tables.

    Events F(m, l) / B(m, l) for logical stage ``l = v*S + s``, device
    ``l % S``: F(m, 0) is always ready, F(m, l) at ``t >= t_F(m, l-1) + 2``;
    B(m, L-1) at ``t >= t_F(m, L-1) + 1``, B(m, l) at ``t >= t_B(m, l+1) +
    2``. One F and one B a device and tick; ties break by the classic
    schedule's issue order, and no F issues before the classic schedule
    would. At V = 1 this is ``t_F = m + 2s``, ``t_B = 2S-1 + m + 2(S-1-s)``,
    ``T = M + 4S - 3``. Returns numpy tables indexed ``[device, tick]``
    (F_valid/F_m/F_v/F_src/F_first, B_valid/B_m/B_v/B_act/B_src/B_last/
    B_first), the ring-buffer depths ``r_act``, ``r_f``, ``r_b`` (each above
    every produce-to-consume gap of the realized schedule), ``t_F``, ``t_B``
    and ``total_ticks``."""
    L = V * S
    t_F: Dict[Tuple[int, int], int] = {}
    t_B: Dict[Tuple[int, int], int] = {}
    rows_f: List[List[Optional[Tuple[int, int]]]] = []
    rows_b: List[List[Optional[Tuple[int, int]]]] = []
    n_events = 2 * M * L
    done = 0
    cap = 4 * (M * V + V * S + S - 1) + 4 * L + 64
    t = 0
    while done < n_events:
        if t > cap:
            raise RuntimeError(f"_overlap_tables(M={M}, S={S}, V={V}) failed to "
                               f"converge within {cap} ticks")
        fr: List[Optional[Tuple[int, int]]] = [None] * S
        br: List[Optional[Tuple[int, int]]] = [None] * S
        for s in range(S):
            best_f = best_b = None
            for v in range(V):
                l = v * S + s
                for m in range(M):
                    g, r = divmod(m, S)
                    if (m, l) not in t_F:
                        key = g * V * S + v * S + r
                        ready = t >= key and (
                            l == 0 or ((m, l - 1) in t_F and t >= t_F[(m, l - 1)] + 2))
                        if ready and (best_f is None or key < best_f[0]):
                            best_f = (key, m, l)
                    if (m, l) not in t_B:
                        if l == L - 1:
                            ready = (m, l) in t_F and t >= t_F[(m, l)] + 1
                        else:
                            ready = (m, l + 1) in t_B and t >= t_B[(m, l + 1)] + 2
                        if ready:
                            key = g * V * S + (V - 1 - l // S) * S + r
                            if best_b is None or key < best_b[0]:
                                best_b = (key, m, l)
            if best_f is not None:
                _, m, l = best_f
                t_F[(m, l)] = t
                fr[s] = (m, l)
                done += 1
            if best_b is not None:
                _, m, l = best_b
                t_B[(m, l)] = t
                br[s] = (m, l)
                done += 1
        rows_f.append(fr)
        rows_b.append(br)
        t += 1
    T = t
    r_act = max(t_B[k] - t_F[k] for k in t_F) + 1
    r_f = max(max([t_F[(m, l)] - (t_F[(m, l - 1)] + 1)
                   for (m, l) in t_F if l > 0] or [1]), 1)
    r_b = max(max([t_B[(m, l)] - (t_B[(m, l + 1)] + 1)
                   for (m, l) in t_B if l < L - 1] or [1]), 1)

    def blank(dtype):
        return np.zeros((S, T), dtype)

    tab = {name: blank(np.bool_) for name in
           ("F_valid", "F_first", "B_valid", "B_first", "B_last")}
    tab.update({name: blank(np.int32) for name in
                ("F_m", "F_v", "F_src", "B_m", "B_v", "B_src", "B_act")})
    for tt, row in enumerate(rows_f):
        for s, ev in enumerate(row):
            if ev is None:
                continue
            m, l = ev
            tab["F_valid"][s, tt], tab["F_m"][s, tt], tab["F_v"][s, tt] = True, m, l // S
            tab["F_first"][s, tt] = l == 0
            if l > 0:
                tab["F_src"][s, tt] = (t_F[(m, l - 1)] + 1) % r_f
    for tt, row in enumerate(rows_b):
        for s, ev in enumerate(row):
            if ev is None:
                continue
            m, l = ev
            tab["B_valid"][s, tt], tab["B_m"][s, tt], tab["B_v"][s, tt] = True, m, l // S
            tab["B_first"][s, tt], tab["B_last"][s, tt] = l == 0, l == L - 1
            tab["B_act"][s, tt] = t_F[(m, l)] % r_act
            if l < L - 1:
                tab["B_src"][s, tt] = (t_B[(m, l + 1)] + 1) % r_b
    tab.update(total_ticks=T, r_act=r_act, r_f=r_f, r_b=r_b, t_F=dict(t_F),
               t_B=dict(t_B))
    return tab


def _pipelined_fwd_bwd_overlap(stage_fn, loss_fn, chunks, inputs, targets, *, V,
                               axis_name, embed_fn=None, embed_params=None,
                               head_fn=None, head_params=None, tensor_shape=None,
                               dtype=None):
    """The table-driven double-buffered engine: :func:`_pipelined_fwd_bwd`
    slot for slot, with the slots from :func:`_overlap_tables`, the rings
    carrying the previous tick's outputs (posted before the tick's compute,
    waited on after it), and the received values in ring buffers of the
    tables' depths, read at the tables' slots."""
    group = get_group(axis_name)
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    M = inputs.shape[0]
    _check_microbatches(M, {"targets": targets.shape[0]}, V, S)
    hidden_shape, hidden_dtype = _hidden(embed_fn, inputs, tensor_shape, dtype)
    tab = _overlap_tables(M, S, V)
    T = tab["total_ticks"]
    _record_schedule(schedule_report(
        M, S, virtual_size=V, schedule="interleaved_1f1b" if V > 1 else "1f1b",
        extra={"p2p_overlap": True, "overlap_total_ticks": T,
               "phase_shift_ticks": T - (M * V + V * S + S - 1)}))
    r_act, r_f, r_b = tab["r_act"], tab["r_f"], tab["r_b"]
    slots = _Slots(stage_fn, loss_fn, chunks, inputs, targets, M, hidden_dtype,
                   embed_fn, embed_params, head_fn, head_params)
    zero = torch.zeros(hidden_shape, dtype=hidden_dtype, device=inputs.device)
    act_buf: List[Optional[torch.Tensor]] = [None] * r_act
    fwd_buf, bwd_buf = [zero] * r_f, [zero] * r_b
    pend_y = pend_dx = zero

    def at(name, t):
        return tab[name][rank, t].item()

    for t in range(T):
        # the previous tick's outputs ride the rings while this tick computes
        with span("pp_p2p_rings"):
            (recv_y, recv_dx), works = (
                p2p_communication.send_forward_recv_backward_double_buffered(
                    pend_y, pend_dx, axis_name=axis_name, async_op=True))
        y = dx = zero
        with span("pp_forward_slot"):
            if at("F_valid", t):
                m_f, v_f = at("F_m", t), at("F_v", t)
                with torch.no_grad():
                    x_in = (slots.embed(embed_params, m_f) if at("F_first", t)
                            else fwd_buf[at("F_src", t)])
                act_buf[t % r_act] = x_in
                if not (rank == S - 1 and v_f == V - 1):
                    y = slots.forward(v_f, x_in)
        with span("pp_backward_slot"):
            if at("B_valid", t):
                got = slots.backward(at("B_v", t), at("B_m", t), act_buf[at("B_act", t)],
                                     bwd_buf[at("B_src", t)], last=at("B_last", t),
                                     first=at("B_first", t))
                dx = zero if got is None else got
        with span("pp_p2p_rings"):
            for work in works:
                work.wait()
        fwd_buf[t % r_f], bwd_buf[t % r_b] = recv_y, recv_dx
        pend_y, pend_dx = y, dx
    return slots.finish(axis_name)


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
    stage_fn = remat_apply(stage_fn, remat_policy)
    engine = _pipelined_fwd_bwd_overlap if overlap_p2p else _pipelined_fwd_bwd
    loss, g_stage, g_embed, g_head = engine(
        stage_fn, loss_fn, [params], inputs, targets, V=1, axis_name=axis_name,
        embed_fn=embed_fn, embed_params=embed_params, head_fn=head_fn,
        head_params=head_params, tensor_shape=tensor_shape, dtype=dtype)
    if embed_fn is None and head_fn is None:
        return loss, g_stage[0]
    return loss, PipelineGrads(g_stage[0], g_embed, g_head)


def forward_backward_pipelining_encoder_decoder(
    stage_fn: Callable,
    loss_fn: Callable,
    params: Any,
    enc_inputs: torch.Tensor,
    dec_inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    split_rank: Optional[int] = None,
    axis_name: str = PIPE_AXIS,
    enc_embed_fn: Optional[Callable] = None,
    enc_embed_params: Any = None,
    dec_embed_fn: Optional[Callable] = None,
    dec_embed_params: Any = None,
    head_fn: Optional[Callable] = None,
    head_params: Any = None,
    remat_policy: Optional[str] = None,
    tensor_shape=None,
    dtype: Optional[torch.dtype] = None,
):
    """T5-style encoder-and-decoder 1F1B schedule (ref:
    schedules/common.py:83,312, ``ModelType.encoder_and_decoder``, and the
    split-rank groups of parallel_state.py:502-560).

    Pipe ranks ``[0, split_rank)`` are encoder stages, ``[split_rank, S)``
    decoder stages; ``split_rank`` defaults to ``parallel_state``'s. The
    rings carry a ``(hidden, memory)`` pair stacked as ``(2, *hidden)``: the
    encoder's last hidden becomes the memory at the split rank, which starts
    the decoder stream from ``dec_embed_fn(dec_inputs[m])``, and the memory
    rides along every decoder stage; the memory's gradient comes back to the
    encoder through the pair's cotangent. ``stage_fn(sp, h, memory,
    is_decoder) -> h``, ``is_decoder`` an fp32 0/1 scalar tensor (encoder
    stages see memory = zeros). Encoder and decoder hiddens share one shape
    and dtype: ``tensor_shape`` and ``dtype`` when an ``enc_embed_fn`` is
    given (eager PyTorch cannot trace it). The slots are the 1F1B engine's
    at V = 1. Returns ``(mean loss, EncDecPipelineGrads)``."""
    stage_fn = remat_apply(stage_fn, remat_policy)
    if split_rank is None:
        from beforeholiday_tpu_torch.parallel import parallel_state

        split_rank = (parallel_state.get_pipeline_model_parallel_split_rank()
                      if parallel_state.model_parallel_is_initialized() else None)
    if split_rank is None:
        raise ValueError("encoder-decoder schedule needs split_rank (or an "
                         "initialized pipeline_model_parallel_split_rank)")
    group = get_group(axis_name)
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    if not 0 < split_rank < S:
        raise ValueError(f"split_rank must satisfy 0 < split_rank < pipeline size "
                         f"({S}), got {split_rank}")
    M = enc_inputs.shape[0]
    if dec_inputs.shape[0] != M or targets.shape[0] != M:
        raise ValueError(
            f"microbatch-count mismatch: enc_inputs has {M} microbatches but "
            f"dec_inputs has {dec_inputs.shape[0]} and targets "
            f"{targets.shape[0]}; all three must agree")
    hidden_shape, hidden_dtype = _hidden(enc_embed_fn, enc_inputs, tensor_shape, dtype)
    total_ticks, ring_depth = M + 2 * S - 1, 2 * S
    _record_schedule(schedule_report(M, S, schedule="1f1b_encoder_decoder",
                                     extra={"split_rank": int(split_rank)}))
    device = enc_inputs.device
    first, last, boundary = rank == 0, rank == S - 1, rank == split_rank
    is_decoder = torch.tensor(float(rank >= split_rank), device=device)
    zero = torch.zeros((2, *hidden_shape), dtype=hidden_dtype, device=device)

    def embed(fn, ep, raw):
        return (fn(ep, raw) if fn is not None else raw).to(hidden_dtype)

    def stage_pair(sp, pair):
        """(h, memory) -> (stage(h), memory); the last stage's h alone,
        what its head and loss take."""
        h = stage_fn(sp, pair[0], pair[1], is_decoder).to(hidden_dtype)
        return h if last else torch.stack([h, pair[1]])

    # the rank's own embedding, as the pair it starts: the encoder's on the
    # first rank, the decoder's at the split rank, none elsewhere
    fn, ep, raw_inputs = ((enc_embed_fn, enc_embed_params, enc_inputs) if first else
                          (dec_embed_fn, dec_embed_params, dec_inputs) if boundary else
                          (None, None, enc_inputs))

    def embed_pair(p, raw):
        return torch.stack([embed(fn, p, raw), torch.zeros_like(zero[0])])

    slots = _Slots(stage_pair, loss_fn, [params], raw_inputs, targets, M, hidden_dtype,
                   embed_pair if fn is not None else None, ep, head_fn, head_params)

    def x_in_of(m, fwd_pair):
        """The pair this rank's stage takes for microbatch m."""
        if first:
            return embed_pair(ep, raw_inputs[m])
        if boundary:
            # the encoder's output arrives in the hidden slot and becomes
            # the memory; the decoder stream starts from its own embedding
            return torch.stack([embed(fn, ep, raw_inputs[m]), fwd_pair[0]])
        return fwd_pair

    act_store: List[Optional[torch.Tensor]] = [None] * ring_depth
    fwd_reg = bwd_reg = zero

    for t in range(total_ticks):
        y = zero
        with span("ppT5_forward_slot"):
            m_f = t - rank
            if 0 <= m_f < M:
                with torch.no_grad():
                    x_in = x_in_of(m_f, fwd_reg)
                act_store[(m_f + rank) % ring_depth] = x_in
                if not last:
                    y = slots.forward(0, x_in)

        dx_ring = zero
        with span("ppT5_backward_slot"):
            m_b = t - S - (S - 1 - rank)
            if 0 <= m_b < M:
                slot = (m_b + rank) % ring_depth
                # the saved pair is the stage's input after x_in_of: its
                # cotangent's hidden half is this rank's own embedding's at
                # the first and the split rank (the slots replay it), and
                # the split rank sends (d memory, 0) upstream, the encoder
                # output's gradient
                dx = slots.backward(0, m_b, act_store[slot], bwd_reg, last=last,
                                    first=first or boundary)
                act_store[slot] = None
                dx = zero if dx is None else dx
                dx_ring = torch.stack([dx[1], torch.zeros_like(dx[1])]) if boundary else dx

        with span("ppT5_p2p_rings"):
            fwd_reg, bwd_reg = p2p_communication.send_forward_recv_backward(
                y, dx_ring, axis_name=axis_name)

    loss = comms.psum(slots.loss, axis_name, site="pp.loss_allreduce")

    def embed_grads(fn_, ep_, mine):
        if fn_ is None:
            return None
        return slots.g_embed if mine else tree_map(torch.zeros_like, ep_)

    g_ee, g_de, g_head = _psum_trees(
        axis_name, embed_grads(enc_embed_fn, enc_embed_params, first),
        embed_grads(dec_embed_fn, dec_embed_params, boundary), slots.g_head)
    return loss, EncDecPipelineGrads(slots.g_stage[0], g_ee, g_de, g_head)


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
    stage_fn = remat_apply(stage_fn, remat_policy)
    V = virtual_pipeline_model_parallel_size
    bad = [tuple(leaf.shape) for leaf in tree_flatten(chunk_params)[0]
           if leaf.shape[0] != V]
    if bad:
        raise ValueError(f"chunk_params leaves must lead with V={V}, got {bad[0]}")
    chunks = [tree_map(lambda leaf, v=v: leaf[v], chunk_params) for v in range(V)]
    engine = _pipelined_fwd_bwd_overlap if overlap_p2p else _pipelined_fwd_bwd
    loss, g_stage, g_embed, g_head = engine(
        stage_fn, loss_fn, chunks, inputs, targets, V=V, axis_name=axis_name,
        embed_fn=embed_fn, embed_params=embed_params, head_fn=head_fn,
        head_params=head_params, tensor_shape=tensor_shape, dtype=dtype)
    leaves = [tree_flatten(g)[0] for g in g_stage]
    stacked = tree_unflatten(tree_flatten(chunk_params)[1],
                             [torch.stack(ls) for ls in zip(*leaves)])
    if embed_fn is None and head_fn is None:
        return loss, stacked
    return loss, PipelineGrads(stacked, g_embed, g_head)
