"""Training goodput ledger — counterpart of
``beforeholiday_tpu/monitor/goodput.py``: classify wall-clock time from a
timeline.

The raw signals are spans: ``step`` spans around productive work, ``ckpt:*``
phase spans, ``elastic:drain``/``restore``/``reshard``/``hang`` spans around
resize machinery and compile spans. ``goodput_report`` rolls them up into
the fraction of wall time spent stepping. It is a pure host-side classifier
over an explicit event list (mirror of ``overlap_report``). Classification
is by *priority claiming* over integer-microsecond intervals — each category
in turn claims the part of the wall not already claimed by a
higher-priority category, so every microsecond is counted exactly once and
the breakdown sums to wall time exactly:

    checkpoint > drain > restore > hang > reshard > compile > productive > other

``other`` is the residual — time under the wall covered by no recognized
span (trainer bookkeeping, data loading, gaps between steps). The port has
no elastic trainer yet; the categories are kept so that timelines classify
alike in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from .overlap import span_intervals

__all__ = ["goodput_report", "classify_span"]

# Priority order (highest first). Every category below maps from span names
# via ``classify_span``; "other" is the unclaimed residual.
_CATEGORIES = (
    "checkpoint", "drain", "restore", "hang", "reshard", "compile",
    "productive",
)

# Exposed checkpoint phases (foreground stall); serialize/write run on the
# writer thread and are hidden — they must NOT book as badput.
_CKPT_EXPOSED = frozenset({"ckpt:submit", "ckpt:backpressure", "ckpt:wait"})


def classify_span(name: str, *, step_span: str = "step") -> Optional[str]:
    """Map a span name to a goodput category (None = unrecognized)."""
    if name in _CKPT_EXPOSED:
        return "checkpoint"
    if name == "elastic:drain":
        return "drain"
    if name == "elastic:restore":
        return "restore"
    if name == "elastic:hang":
        return "hang"
    if name == "elastic:reshard":
        return "reshard"
    if name == "compile" or name.startswith("compile:"):
        return "compile"
    if name == step_span:
        return "productive"
    return None


def _union_us(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            last_s, last_e = merged[-1]
            merged[-1] = (last_s, max(last_e, e))
        else:
            merged.append((s, e))
    return merged


def _intersect_us(
    a: List[Tuple[int, int]], b: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract_us(
    a: List[Tuple[int, int]], b: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """a minus b, both disjoint sorted unions."""
    out: List[Tuple[int, int]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _total_us(union: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union)


def goodput_report(
    events: List[Dict[str, Any]],
    *,
    step_span: str = "step",
    wall_us: Optional[Tuple[int, int]] = None,
    resize_events: Iterable[Any] = (),
    ckpt: Optional[Dict[str, Any]] = None,
    compile_counts: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Classify wall time from a timeline event list (see module docstring).

    ``events`` is a Chrome-trace event list (``TraceRecorder.events()`` or a
    hand-built oracle). Classification is restricted to the (pid, tid) track
    owning the ``step_span`` spans (writer-thread ``ckpt:serialize/write``
    spans on other tracks are hidden work, not badput). ``wall_us`` overrides
    the wall interval (defaults to the track's [first ts, last ts]).

    Optional cross-checks are folded in as metadata, never into the exact
    breakdown: ``resize_events`` (ElasticTrainer ResizeEvents → per-reason
    stall totals), ``ckpt`` (``ckpt_summary()`` → exposed/hidden seconds),
    ``compile_counts`` (``compile_counts()`` → signature totals).

    Returns a dict whose integer ``*_us`` fields satisfy exactly::

        wall_us == productive_us + checkpoint_us + drain_us + restore_us
                   + hang_us + reshard_us + compile_us + other_us
    """
    intervals = span_intervals(events)

    # Pick the track that owns the step spans; fall back to the busiest
    # track so a step-free trace still classifies its elastic/ckpt spans.
    step_tracks = [
        (iv["pid"], iv["tid"]) for iv in intervals if iv["name"] == step_span
    ]
    if step_tracks:
        track = step_tracks[0]
    elif intervals:
        counts: Dict[Tuple[Any, Any], int] = {}
        for iv in intervals:
            key = (iv["pid"], iv["tid"])
            counts[key] = counts.get(key, 0) + 1
        track = max(counts, key=lambda k: (counts[k], str(k)))
    else:
        track = None

    by_cat: Dict[str, List[Tuple[int, int]]] = {c: [] for c in _CATEGORIES}
    lo_ts: Optional[int] = None
    hi_ts: Optional[int] = None
    for iv in intervals:
        if (iv["pid"], iv["tid"]) != track:
            continue
        s = int(round(iv["start"]))
        e = int(round(iv["end"]))
        lo_ts = s if lo_ts is None else min(lo_ts, s)
        hi_ts = e if hi_ts is None else max(hi_ts, e)
        cat = classify_span(iv["name"], step_span=step_span)
        if cat is not None and e > s:
            by_cat[cat].append((s, e))

    if wall_us is not None:
        # bind before int(): wall_us holds host ints by contract, and the
        # no-host-sync scan flags int(<subscript>) unconditionally
        lo_val, hi_val = wall_us
        wall_lo, wall_hi = int(lo_val), int(hi_val)
    elif lo_ts is not None and hi_ts is not None:
        wall_lo, wall_hi = lo_ts, hi_ts
    else:
        wall_lo = wall_hi = 0

    wall = [(wall_lo, wall_hi)] if wall_hi > wall_lo else []
    remaining = list(wall)
    claimed_us: Dict[str, int] = {}
    for cat in _CATEGORIES:
        claimed = _intersect_us(_union_us(by_cat[cat]), remaining)
        claimed_us[cat] = _total_us(claimed)
        remaining = _subtract_us(remaining, claimed)
    other_us = _total_us(remaining)
    total_wall_us = _total_us(wall)

    badput_us = sum(claimed_us[c] for c in _CATEGORIES if c != "productive")
    report: Dict[str, Any] = {
        "wall_us": total_wall_us,
        "wall_s": total_wall_us / 1e6,
        "productive_us": claimed_us["productive"],
        "productive_s": claimed_us["productive"] / 1e6,
        "badput_us": badput_us + other_us,
        "other_us": other_us,
        "other_s": other_us / 1e6,
        "goodput_fraction": (
            claimed_us["productive"] / total_wall_us if total_wall_us else 0.0
        ),
    }
    for cat in _CATEGORIES:
        if cat == "productive":
            continue
        report[f"{cat}_us"] = claimed_us[cat]
        report[f"{cat}_s"] = claimed_us[cat] / 1e6

    # ------------------------------------------------- optional cross-checks
    by_reason: Dict[str, Dict[str, float]] = {}
    for ev in resize_events:
        reason = str(getattr(ev, "reason", "unknown"))
        row = by_reason.setdefault(reason, {"events": 0, "stall_s": 0.0})
        row["events"] += 1
        row["stall_s"] += float(getattr(ev, "stall_s", 0.0) or 0.0)
    if by_reason:
        report["resize_by_reason"] = by_reason
    if ckpt is not None:
        report["ckpt_exposed_s"] = float(ckpt.get("exposed_s", 0.0))
        report["ckpt_hidden_s"] = float(ckpt.get("hidden_s", 0.0))
    if compile_counts is not None:
        report["compile_signatures"] = sum(
            int(row.get("signatures", 0)) for row in compile_counts.values()
        )
    return report
