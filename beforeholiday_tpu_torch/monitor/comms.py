"""Collective-traffic ledger — counterpart of
``beforeholiday_tpu/monitor/comms.py``.

Every collective the port issues goes through a wrapper here, which books
it and then calls ``torch.distributed`` (NCCL on the card, gloo on the CPU)
over the process group that ``axis_name`` names (see
``parallel.parallel_state.get_group``). The ledger is a host-side dict:
booking reads no device value, so it adds no host sync to a step.

What a record means — the JAX package's contract, with one change of
clock: JAX books a collective once per TRACE (a compiled step books it once
however often it runs), eager PyTorch books it once per CALL. So the port's
ledger after one step holds what the JAX ledger holds after one trace of the
same step: the same sites, kinds, tiers and bytes. Each record carries the
op kind, the axis label, the dtype, the per-rank local payload bytes (the
operand each rank hands to the interconnect), the uncompressed
``logical_bytes`` (a compressed collective passes its fp32 stand-in), a
call-site tag, the joined :func:`ledger_scope` stack and the tier ("dcn"
for an axis that crosses the slice tier, else "ici"; NVLink and PCIe book as
"ici" here). Two kinds of collective the JAX ledger cannot see, because
they never pass through its wrappers, are booked here all the same:
autodiff's transposes (the SyncBN backward's all-reduce, site
``sync_bn.backward``) and ``lax.pmean`` (the trainer's metrics and BN state,
``trainer.*``).

``comms_records()`` is the per-key snapshot, ``comms_summary()`` the rollup
by subsystem (the site tag's prefix before the first ``.``), and
``reset_comms_ledger()`` clears it between entry points.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "all_to_all",
    "comms_records",
    "comms_summary",
    "infer_tier",
    "ledger_scope",
    "logical",
    "pmax",
    "pmin",
    "ppermute",
    "psum",
    "psum_scatter",
    "record",
    "reset_comms_ledger",
]

_LOCK = threading.Lock()
# (kind, axis, dtype, site, scope, tier) -> {"calls", "bytes", "logical_bytes"}
_RECORDS: Dict[Tuple[str, str, str, str, str, str], Dict[str, int]] = {}
_TLS = threading.local()

# axes that cross the slow inter-slice tier (parallel_state.SLICE_AXIS)
DCN_AXES = frozenset({"slice"})


def _axis_names(axis_name: Any) -> Tuple[str, ...]:
    if isinstance(axis_name, (tuple, list)):
        return tuple(str(a) for a in axis_name)
    if isinstance(axis_name, str):
        return (axis_name,)
    return ("group",)  # a ProcessGroup handed in directly


def _axis_label(axis_name: Any) -> str:
    if isinstance(axis_name, (str, tuple, list)):
        return str(axis_name)
    return "group"


def infer_tier(axis_name: Any) -> str:
    """"dcn" when the axis spec crosses a slice boundary, else "ici"."""
    return "dcn" if any(a in DCN_AXES for a in _axis_names(axis_name)) else "ici"


def _scope_stack() -> List[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextlib.contextmanager
def ledger_scope(name: str):
    """Label every collective booked inside the block (nests; per thread)."""
    st = _scope_stack()
    st.append(name)
    try:
        yield
    finally:
        st.pop()


def logical(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A stand-in for "what this payload would cost uncompressed": a meta
    tensor, so nothing is allocated or computed."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _payload_bytes(tree: Any) -> Dict[str, int]:
    """Per-dtype payload bytes over a tensor or a sequence of tensors."""
    leaves = list(tree) if isinstance(tree, (list, tuple)) else [tree]
    out: Dict[str, int] = {}
    for t in leaves:
        name = _dtype_name(t.dtype)
        out[name] = out.get(name, 0) + math.prod(t.shape) * t.element_size()
    return out


def record(kind: str, axis_name: Any, tree: Any, *, site: str,
           logical: Any = None, tier: str = None) -> None:
    """Book one collective call. ``tree`` is the operand handed to the
    interconnect (so ``bytes`` is the wire payload); ``logical`` its
    uncompressed stand-in (see :func:`logical`); ``tier`` defaults to
    :func:`infer_tier` of the axis."""
    scope = ".".join(_scope_stack())
    if tier is None:
        tier = infer_tier(axis_name)
    payload = _payload_bytes(tree)
    wire_total = sum(payload.values())
    logical_total = (sum(_payload_bytes(logical).values())
                     if logical is not None else wire_total)
    axis = _axis_label(axis_name)
    with _LOCK:
        for dtype_name, nbytes in payload.items():
            key = (kind, axis, dtype_name, site, scope, tier)
            row = _RECORDS.setdefault(
                key, {"calls": 0, "bytes": 0, "logical_bytes": 0})
            row["calls"] += 1
            row["bytes"] += nbytes
            row["logical_bytes"] += (
                logical_total * nbytes // wire_total if wire_total else nbytes)


def _group(axis_name: Any, axis_index_groups=None):
    from beforeholiday_tpu_torch.parallel import parallel_state

    return parallel_state.get_group(axis_name, axis_index_groups)


def _world(group) -> int:
    return dist.get_world_size(group)


# ------------------------------------------------------------------ wrappers
# Each takes the JAX wrapper's arguments plus ``async_op``: with it the call
# returns ``(result, work)`` and the caller waits on ``work`` before reading
# the result (on NCCL, ``work.wait()`` makes the current stream wait; the
# host does not block).


def _finish(out, work, async_op):
    return (out, work) if async_op else out


def _all_reduce(x, axis_name, op, *, site, kind, axis_index_groups=None,
                logical=None, tier=None, async_op=False, inplace=False):
    record(kind, axis_name, x, site=site, logical=logical, tier=tier)
    group = _group(axis_name, axis_index_groups)
    if isinstance(x, (list, tuple)):
        # JAX's variadic psum: one collective over the concatenated leaves
        flat = torch.cat([t.reshape(-1) for t in x])
        work = dist.all_reduce(flat, op=op, group=group, async_op=async_op)
        outs, off = [], 0
        for t in x:
            outs.append(flat[off: off + t.numel()].view(t.shape))
            off += t.numel()
        return _finish(outs, work, async_op)
    out = x if inplace else x.clone(memory_format=torch.contiguous_format)
    work = dist.all_reduce(out, op=op, group=group, async_op=async_op)
    return _finish(out, work, async_op)


def psum(x, axis_name, *, site: str, axis_index_groups=None, logical=None,
         tier=None, async_op: bool = False, inplace: bool = False):
    """Sum over the group; ``x`` a tensor, or a list of same-dtype tensors
    reduced as one collective (JAX's variadic psum). ``inplace`` reduces
    ``x`` itself."""
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM, site=site, kind="psum",
                       axis_index_groups=axis_index_groups, logical=logical,
                       tier=tier, async_op=async_op, inplace=inplace)


def pmax(x, axis_name, *, site: str, axis_index_groups=None, tier=None,
         async_op: bool = False):
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX, site=site, kind="pmax",
                       axis_index_groups=axis_index_groups, tier=tier,
                       async_op=async_op)


def pmin(x, axis_name, *, site: str, axis_index_groups=None, tier=None,
         async_op: bool = False):
    return _all_reduce(x, axis_name, dist.ReduceOp.MIN, site=site, kind="pmin",
                       axis_index_groups=axis_index_groups, tier=tier,
                       async_op=async_op)


def all_gather(x, axis_name, *, site: str, axis: int = 0, tiled: bool = False,
               logical=None, tier=None, async_op: bool = False):
    """Every rank's ``x`` in rank order: stacked along a new axis at
    ``axis`` (``tiled``: concatenated along ``axis``), as ``lax.all_gather``
    lays them out. The collective gathers along a leading rank axis; another
    ``axis`` is a local move after it (with ``async_op``, a view the caller
    reads after waiting on the work)."""
    record("all_gather", axis_name, x, site=site, logical=logical, tier=tier)
    group = _group(axis_name)
    world = _world(group)
    src = x.reshape(1) if x.ndim == 0 else x.contiguous()
    out = torch.empty((world * src.shape[0], *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # newer PyTorch renames all_gather_into_tensor to all_gather_single
    ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    work = ag(out, src, group=group, async_op=async_op)
    stacked = out.view(world, *x.shape)
    if tiled:
        axis = axis % max(x.ndim, 1)
        out = out if axis == 0 else torch.cat(stacked.unbind(0), dim=axis)
    else:
        out = stacked.movedim(0, axis % (x.ndim + 1))
    return _finish(out, work, async_op)


def psum_scatter(x, axis_name, *, site: str, scatter_dimension: int = 0,
                 tiled: bool = False, logical=None, tier=None,
                 async_op: bool = False):
    """Sum over the group, each rank keeping its block of
    ``scatter_dimension`` (``tiled``: a block of ``n / world`` rows; else
    the dimension must equal the world size and is dropped)."""
    record("psum_scatter", axis_name, x, site=site, logical=logical, tier=tier)
    group = _group(axis_name)
    world = _world(group)
    src = x.movedim(scatter_dimension, 0).contiguous()
    if src.shape[0] % world:
        raise ValueError(f"psum_scatter: dimension {src.shape[0]} is not "
                         f"divisible by the world size {world}")
    out = torch.empty((src.shape[0] // world, *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # newer PyTorch renames reduce_scatter_tensor to reduce_scatter_single
    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    work = rs(out, src, group=group, async_op=async_op)
    if not tiled:
        if src.shape[0] != world:
            raise ValueError("an untiled psum_scatter needs the scattered "
                             "dimension to equal the world size")
        out = out[0]
    elif scatter_dimension:
        out = out.movedim(0, scatter_dimension)
    return _finish(out, work, async_op)


def ppermute(x, axis_name, perm, *, site: str, tier=None):
    """``lax.ppermute``: ``perm`` lists ``(source, destination)`` pairs of
    group-local ranks; this rank sends ``x`` to its destination and returns
    what its source sent (zeros where no pair names it a destination). One
    ``batch_isend_irecv`` over the group; a pair onto itself is a copy."""
    record("ppermute", axis_name, x, site=site, tier=tier)
    group = _group(axis_name)
    members = dist.get_process_group_ranks(group)
    me = members.index(dist.get_rank())
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {me} appears twice in {perm}")
    src_t = x.contiguous()
    out = torch.zeros_like(src_t)
    ops = []
    if dst and dst[0] == me:
        out.copy_(src_t)
    elif dst:
        ops.append(dist.P2POp(dist.isend, src_t, members[dst[0]], group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out, members[src[0]], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *, site: str,
               tiled: bool = False, logical=None, tier=None,
               async_op: bool = False):
    """Rank-major exchange along axis 0 (``split_axis == concat_axis ==
    0``, the form the compressed all-reduce uses): row ``j`` of the result
    is rank ``j``'s row for this rank."""
    if split_axis != 0 or concat_axis != 0:
        raise NotImplementedError(
            "all_to_all is ported for split_axis == concat_axis == 0")
    record("all_to_all", axis_name, x, site=site, logical=logical, tier=tier)
    group = _group(axis_name)
    src = x.contiguous()
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=group, async_op=async_op)
    return _finish(out, work, async_op)


# ------------------------------------------------------------------- queries


def comms_records() -> List[Dict[str, object]]:
    """One row per distinct (kind, axis, dtype, site, scope, tier):
    ``{"kind", "axis", "dtype", "site", "scope", "tier", "calls",
    "bytes", "logical_bytes"}``, sorted as the JAX package sorts them."""
    with _LOCK:
        items = [(k, dict(v)) for k, v in _RECORDS.items()]
    return sorted(
        ({"kind": kind, "axis": axis, "dtype": dtype, "site": site,
          "scope": scope, "tier": tier, "calls": c["calls"],
          "bytes": c["bytes"], "logical_bytes": c["logical_bytes"]}
         for (kind, axis, dtype, site, scope, tier), c in items),
        key=lambda r: (r["site"], r["kind"], r["dtype"], r["scope"],
                       r["tier"]),
    )


def comms_summary() -> List[Dict[str, object]]:
    """Rollup by subsystem (the site tag before its first ``.``):
    ``{"subsystem", "sites", "calls", "bytes", "logical_bytes",
    "compression_ratio", "by_kind", "by_tier"}``, as the JAX package's."""
    by_sub: Dict[str, Dict[str, Any]] = {}
    sites_seen: Dict[str, set] = {}
    for r in comms_records():
        sub = str(r["site"]).split(".", 1)[0]
        row = by_sub.setdefault(sub, {
            "subsystem": sub, "sites": 0, "calls": 0, "bytes": 0,
            "logical_bytes": 0, "by_kind": {}, "by_tier": {}})
        sites_seen.setdefault(sub, set()).add(r["site"])
        for k in ("calls", "bytes", "logical_bytes"):
            row[k] += r[k]
        kind_row = row["by_kind"].setdefault(r["kind"], {"calls": 0, "bytes": 0})
        kind_row["calls"] += r["calls"]
        kind_row["bytes"] += r["bytes"]
        tier_row = row["by_tier"].setdefault(
            r["tier"], {"calls": 0, "bytes": 0, "logical_bytes": 0})
        for k in ("calls", "bytes", "logical_bytes"):
            tier_row[k] += r[k]
    for sub, row in by_sub.items():
        row["sites"] = len(sites_seen[sub])
        for r in (row, *row["by_tier"].values()):
            r["compression_ratio"] = (round(r["logical_bytes"] / r["bytes"], 4)
                                      if r["bytes"] else 1.0)
    return sorted(by_sub.values(), key=lambda r: r["subsystem"])


def reset_comms_ledger() -> None:
    """Clear the ledger."""
    with _LOCK:
        _RECORDS.clear()
