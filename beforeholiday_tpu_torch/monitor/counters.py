"""Queryable dispatch counters — counterpart of
``beforeholiday_tpu/monitor/counters.py``.

The JAX package's counters read ``guard/dispatch.py``'s probe cache: did an
(op, backend, shapes, statics) key take the Pallas kernel or degrade to the
jnp oracle, and was a probe built? The port has no probe and no fallback
(a wrapper launches its kernel or raises), so its counterpart of
``checked_impl``'s hits is ``ops/_dispatch.py`` ``resolve_impl``'s choice,
counted per (op, device type, dtype) at every call (eager PyTorch has no
trace time). The records keep the JAX shape: ``pallas`` counts the choices
of the hand-written kernel, ``jnp`` those of the plain PyTorch version,
``probes`` and every degrade are 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from beforeholiday_tpu_torch.ops import _dispatch

__all__ = [
    "dispatch_counters",
    "dispatch_records",
    "dispatch_summary",
    "reset_counters",
    "reset_dispatch_counters",
]


def _ratio(kernel: int, plain: int) -> float:
    total = kernel + plain
    return round(kernel / total, 4) if total else 0.0


def dispatch_counters() -> Dict[Tuple, Dict[str, int]]:
    """Per-key snapshot: ``{(op, device type, dtype): {"pallas": n, "jnp":
    n, "probes": 0}}`` (the kernel's and the plain version's choices)."""
    return {key: {"pallas": c["kernel"], "jnp": c["torch"], "probes": 0}
            for key, c in _dispatch.dispatch_counts().items()}


def reset_dispatch_counters() -> None:
    _dispatch.reset_dispatch_counts()


def reset_counters() -> None:
    """Full dispatch-telemetry reset (the port keeps no probe warnings, so
    this is :func:`reset_dispatch_counters`)."""
    _dispatch.reset_dispatch_counts()


def dispatch_records() -> List[Dict[str, object]]:
    """Per-key JSON-ready rows: ``{"op", "key", "pallas", "jnp", "probes",
    "pallas_ratio", "degraded"}``."""
    return sorted(
        (
            {
                "op": key[0],
                "key": repr(key[1:]),
                "pallas": c["pallas"],
                "jnp": c["jnp"],
                "probes": c["probes"],
                "pallas_ratio": _ratio(c["pallas"], c["jnp"]),
                "degraded": False,
            }
            for key, c in dispatch_counters().items()
        ),
        key=lambda r: (r["op"], r["key"]),
    )


def dispatch_summary() -> List[Dict[str, object]]:
    """Op-level rollup, one JSON-ready row per op name: ``{"op", "keys",
    "pallas", "jnp", "probes", "pallas_ratio", "degraded_keys"}``
    (``pallas_ratio`` = the fraction of the op's calls that took the
    kernel: 1.0 on the card, 0.0 on the CPU)."""
    by_op: Dict[str, Dict[str, object]] = {}
    for key, c in dispatch_counters().items():
        row = by_op.setdefault(
            key[0],
            {"op": key[0], "keys": 0, "pallas": 0, "jnp": 0, "probes": 0,
             "degraded_keys": 0},
        )
        row["keys"] += 1
        row["pallas"] += c["pallas"]
        row["jnp"] += c["jnp"]
    for row in by_op.values():
        row["pallas_ratio"] = _ratio(row["pallas"], row["jnp"])
    return sorted(by_op.values(), key=lambda r: r["op"])
