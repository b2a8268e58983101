"""Measured compute/comms overlap and cross-rank straggler skew —
counterpart of ``beforeholiday_tpu/monitor/overlap.py``: interval
arithmetic over the host timeline the trace layer records.

The timeline (``monitor/trace.py``) holds ``B``/``E`` spans per (pid=rank,
tid=thread), so this module is host-side arithmetic over an event list:

* :func:`overlap_report` — per step (spans named ``step_span``), the
  fraction of comms interval time covered by concurrent compute intervals:
  ``overlap_fraction = |union(comms) ∩ union(compute)| / |union(comms)|``.
  Spans count as comms when their name carries a collective kind prefix
  (``psum:…``) or starts with ``comms``.
* :func:`straggler_report` — for every span name recorded by 2+ ranks
  (pids), the per-rank duration spread: ``skew_us = max - min`` and
  ``skew_rel = skew / mean``, worst first, naming the straggling rank.
* :func:`rank_skew` — the device-side half: the sum / max / min of a
  per-rank duration over a ``torch.distributed`` group through the
  ledger-booked collectives (``monitor.comms``), for skew measured on the
  device where host timestamps do not exist per rank.

Everything except :func:`rank_skew` is plain float arithmetic on host dicts
— no device values, no syncs. The spans are host spans: where a span
encloses asynchronous device work, its duration is the host's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "overlap_report",
    "rank_skew",
    "span_intervals",
    "straggler_report",
]

# Span/instant name prefixes that mean "this is wire time": the comms ledger
# mirrors records as "<kind>:<site>" and the overlap engine's own spans use a
# plain "comms" prefix. "ckpt" covers the elastic checkpoint phases
# (``ckpt:<phase>`` spans from elastic/checkpoint.py) and "d2h" the
# device→host snapshot instants — checkpoint stall is wire-class time the
# step must hide exactly like a collective.
_COMMS_KINDS = (
    "psum", "pmax", "pmin", "all_gather", "psum_scatter", "ppermute",
    "all_to_all", "reduce_scatter", "allreduce", "comms", "ckpt", "d2h",
)


def _default_is_comms(name: str) -> bool:
    head = name.split(":", 1)[0]
    return head in _COMMS_KINDS or name.startswith("comms")


# ------------------------------------------------------ interval extraction
def span_intervals(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Match ``B``/``E`` pairs per (pid, tid) into closed intervals:
    ``{"name", "start", "end", "pid", "tid", "depth"}`` (timestamps in the
    recorder's microseconds; depth 0 = outermost). Unclosed spans are
    dropped — a crash mid-span must not fabricate a duration."""
    stacks: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    out: List[Dict[str, Any]] = []
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("B", "E"):
            continue
        key = (ev.get("pid", 0), ev.get("tid", 0))
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append({
                "name": ev.get("name", ""),
                "start": ev["ts"],
                "pid": key[0],
                "tid": key[1],
                "depth": len(stack),
            })
        elif stack:
            iv = stack.pop()
            iv["end"] = ev["ts"]
            out.append(iv)
    out.sort(key=lambda iv: (iv["pid"], iv["tid"], iv["start"]))
    return out


def _union(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping (start, end) pairs into a disjoint union."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            last_s, last_e = merged[-1]
            merged[-1] = (last_s, max(last_e, e))
        else:
            merged.append((s, e))
    return merged


def _total(union: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union)


def _intersect(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    """Total length of the intersection of two disjoint unions."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(
    ivs: List[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    return [
        (max(s, lo), min(e, hi)) for s, e in ivs if min(e, hi) > max(s, lo)
    ]


# ------------------------------------------------------------ overlap report
def overlap_report(
    events: List[Dict[str, Any]],
    *,
    step_span: str = "step",
    is_comms: Optional[Callable[[str], bool]] = None,
) -> Dict[str, Any]:
    """Per-step achieved overlap from a timeline event list.

    Steps are spans named ``step_span`` (when none exist, the whole trace is
    treated as one step). Within each step, spans partition into comms
    (``is_comms(name)``, default: collective-kind prefixes) and compute
    (everything else below the step span); the step's ``overlap_fraction``
    is the fraction of the comms union covered by the compute union —
    comms time hidden under the math. Steps with no comms report None.

    Returns ``{"steps": [per-step rows], "overlap_fraction": total-weighted
    fraction | None, "comms_us", "hidden_us", "exposed_us"}``.
    """
    check = is_comms if is_comms is not None else _default_is_comms
    intervals = span_intervals(events)
    steps = [iv for iv in intervals if iv["name"] == step_span]
    if not steps:
        ts = [iv["start"] for iv in intervals] + [iv["end"] for iv in intervals]
        if not ts:
            return {"steps": [], "overlap_fraction": None,
                    "comms_us": 0.0, "hidden_us": 0.0, "exposed_us": 0.0}
        steps = [{"name": step_span, "start": min(ts), "end": max(ts),
                  "pid": None, "tid": None, "depth": -1}]
    else:
        steps.sort(key=lambda iv: iv["start"])

    inner = [iv for iv in intervals if iv["name"] != step_span]
    rows: List[Dict[str, Any]] = []
    total_comms = total_hidden = 0.0
    for idx, st in enumerate(steps):
        lo, hi = st["start"], st["end"]
        in_step = [
            iv for iv in inner
            if iv["end"] > lo and iv["start"] < hi
            and (st["pid"] is None or iv["pid"] == st["pid"])
        ]
        comms_u = _union(_clip(
            [(iv["start"], iv["end"]) for iv in in_step
             if check(iv["name"])], lo, hi))
        compute_u = _union(_clip(
            [(iv["start"], iv["end"]) for iv in in_step
             if not check(iv["name"])], lo, hi))
        comms_us = _total(comms_u)
        hidden_us = _intersect(comms_u, compute_u)
        rows.append({
            "step_index": idx,
            "pid": st["pid"],
            "start_us": lo,
            "end_us": hi,
            "comms_us": comms_us,
            "compute_us": _total(compute_u),
            "hidden_us": hidden_us,
            "exposed_us": comms_us - hidden_us,
            "overlap_fraction": hidden_us / comms_us if comms_us else None,
        })
        total_comms += comms_us
        total_hidden += hidden_us
    return {
        "steps": rows,
        "overlap_fraction": (
            total_hidden / total_comms if total_comms else None
        ),
        "comms_us": total_comms,
        "hidden_us": total_hidden,
        "exposed_us": total_comms - total_hidden,
    }


# ---------------------------------------------------------- straggler report
def straggler_report(
    events: List[Dict[str, Any]],
    *,
    min_ranks: int = 2,
) -> List[Dict[str, Any]]:
    """Cross-rank span skew from a timeline: for every span name recorded by
    at least ``min_ranks`` distinct pids, the spread of per-rank TOTAL
    duration — ``{"name", "ranks", "mean_us", "min_us", "max_us",
    "max_rank", "skew_us", "skew_rel"}``, sorted worst (largest ``skew_us``)
    first. The rank under ``max_rank`` is the straggler: it held the span
    longest, and every collective inside the span made the others wait."""
    per: Dict[str, Dict[Any, float]] = {}
    for iv in span_intervals(events):
        per.setdefault(iv["name"], {})
        by_rank = per[iv["name"]]
        by_rank[iv["pid"]] = by_rank.get(iv["pid"], 0.0) + (
            iv["end"] - iv["start"]
        )
    rows = []
    for name, by_rank in per.items():
        if len(by_rank) < min_ranks:
            continue
        durs = list(by_rank.values())
        mean = sum(durs) / len(durs)
        hi = max(durs)
        lo = min(durs)
        max_rank = max(by_rank, key=lambda r: by_rank[r])
        rows.append({
            "name": name,
            "ranks": len(by_rank),
            "mean_us": mean,
            "min_us": lo,
            "max_us": hi,
            "max_rank": max_rank,
            "skew_us": hi - lo,
            "skew_rel": (hi - lo) / mean if mean else 0.0,
        })
    rows.sort(key=lambda r: -r["skew_us"])
    return rows


# ------------------------------------------------------- device-side skew
def rank_skew(
    duration: Any,
    axis_name: str,
    *,
    site: str = "monitor.rank_skew",
) -> Dict[str, Any]:
    """Aggregate a per-rank duration scalar across the ``torch.distributed``
    group of ``axis_name`` on the device (a per-rank iteration count or a
    device-timed kernel), through the ledger-booked psum / pmax / pmin so the
    traffic is accounted like every other collective.

    Returns 0-d fp32 device tensors ``{"mean", "max", "min", "skew",
    "skew_rel"}``; pack them into the metrics vector and drain as usual."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel.parallel_state import get_group

    d = torch.as_tensor(duration, dtype=torch.float32)
    world = dist.get_world_size(get_group(axis_name))
    mean = comms.psum(d, axis_name, site=site) / world
    hi = comms.pmax(d, axis_name, site=site)
    lo = comms.pmin(d, axis_name, site=site)
    skew = hi - lo
    return {
        "mean": mean,
        "max": hi,
        "min": lo,
        "skew": skew,
        "skew_rel": skew / torch.clamp(mean, min=1e-12),
    }
