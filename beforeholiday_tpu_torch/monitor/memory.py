"""Per-entry memory ledger — counterpart of
``beforeholiday_tpu/monitor/memory.py``.

The JAX ledger reads XLA's AOT ``memory_analysis()`` per jitted entry and
abstract signature. Eager PyTorch compiles nothing, so the port reads the
call itself, the first time each signature is called and every time after
(a signature's record keeps the largest reading), and each record names its
``method``:

* ``"allocator"`` — an entry called with CUDA tensors (or with none while
  a card is present) is read from the CUDA caching allocator:
  ``temp_bytes`` is the peak allocated during the call above what was
  allocated at entry (``reset_peak_memory_stats`` before the call,
  ``max_memory_allocated`` after). Both are host-side allocator queries:
  the allocator books an allocation when the host issues it, so no device
  sync is needed.
* ``"saved_tensors"`` — the CPU has no allocator statistics. Its
  ``temp_bytes`` is what the forward leaves for the backward: the bytes
  autograd saves (``torch.autograd.graph.saved_tensors_hooks``), plus, for
  a region under a remat policy (``remat.apply``), the inputs the
  checkpoint keeps and the outputs its selective policy saves, each storage
  counted once. It is the quantity remat exists to shrink, not a peak.

``argument_bytes`` and ``output_bytes`` are the distinct storages of the
call's tensor arguments and results, ``alias_bytes`` the results' storages
that are also arguments' (an in-place update), ``generated_code_bytes`` 0:
the records have the JAX ledger's keys. New records are mirrored to the
active trace recorder as ``memory:<entry>`` instants. State is
process-global; ``reset_memory_ledger()`` clears it.

A reading resets the allocator's peak statistic, so two tracked entries do
not nest.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from beforeholiday_tpu_torch.monitor.compile import _sig_of

__all__ = [
    "measure_memory",
    "memory_records",
    "memory_summary",
    "reset_memory_ledger",
    "track_memory",
]

_LOCK = threading.Lock()
# entry -> {"signatures": {sig: stats dict}, "calls": int}
_ENTRIES: Dict[str, Dict[str, Any]] = {}

_STAT_FIELDS = ("temp_bytes", "argument_bytes", "output_bytes", "alias_bytes",
                "generated_code_bytes")


def _tensors(obj):
    """Every tensor in a nest of tuples, lists, dicts and objects with an
    ``arenas`` list (``PackedParams``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif hasattr(obj, "arenas"):
        yield from _tensors(obj.arenas)


def _storages(obj) -> Dict[Any, int]:
    """``{(device, storage address): bytes}`` of the distinct storages."""
    out = {}
    for t in _tensors(obj):
        st = t.untyped_storage()
        out[(str(t.device), st.data_ptr())] = st.nbytes()
    return out


class _SavedBytes:
    """The CPU reading: the distinct storages kept for the backward. Holds
    a reference to each until the reading closes, so that no address is
    reused and counted twice."""

    def __init__(self):
        self.seen: Dict[Any, int] = {}
        self.refs: List[torch.Tensor] = []

    def keep(self, obj) -> None:
        for t in _tensors(obj):
            st = t.untyped_storage()
            key = (str(t.device), st.data_ptr())
            if key not in self.seen:
                self.seen[key] = st.nbytes()
                self.refs.append(t)

    def pack(self, t):
        self.keep(t)
        return t

    @property
    def total(self) -> int:
        return sum(self.seen.values())


class _Reading(threading.local):
    saved: Optional[_SavedBytes] = None


_READING = _Reading()


def _saved_bytes_keeper() -> Optional[Callable]:
    """The open CPU reading's ``keep`` (for ``remat.apply``), or None."""
    saved = _READING.saved
    return None if saved is None else saved.keep


def _device_of(args, kwargs) -> torch.device:
    for t in _tensors((args, kwargs)):
        if t.is_cuda:
            return t.device
    for _ in _tensors((args, kwargs)):
        return torch.device("cpu")
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _measure(fn: Callable, args, kwargs):
    """``(result, stats)`` of one call of ``fn``."""
    device = _device_of(args, kwargs)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = fn(*args, **kwargs)
        temp = torch.cuda.max_memory_allocated(device) - base
        method = "allocator"
    else:
        saved = _SavedBytes()
        prev, _READING.saved = _READING.saved, saved
        try:
            with torch.autograd.graph.saved_tensors_hooks(saved.pack, lambda t: t):
                out = fn(*args, **kwargs)
        finally:
            _READING.saved = prev
        temp = saved.total
        method = "saved_tensors"
    arg_st, out_st = _storages((args, kwargs)), _storages(out)
    stats = {
        "temp_bytes": int(temp),
        "argument_bytes": sum(arg_st.values()),
        "output_bytes": sum(out_st.values()),
        "alias_bytes": sum(v for k, v in out_st.items() if k in arg_st),
        "generated_code_bytes": 0,
        "method": method,
    }
    return out, stats


def _mirror_to_trace(entry: str, stats: Optional[Dict[str, Any]]) -> None:
    """Emit the record as an instant event on the active trace recorder."""
    if stats is None:
        return
    from beforeholiday_tpu_torch.monitor.trace import active_recorder

    rec = active_recorder()
    if rec is not None:
        rec.instant(f"memory:{entry}", args=dict(stats))


def _record(entry: str, sig, stats: Dict[str, Any], calls: int) -> None:
    with _LOCK:
        row = _ENTRIES.setdefault(entry, {"signatures": {}, "calls": 0})
        row["calls"] += calls
        old = row["signatures"].get(sig)
        new = old is None
        if new or stats["temp_bytes"] > old["temp_bytes"]:
            row["signatures"][sig] = stats
    if new:
        _mirror_to_trace(entry, stats)


def track_memory(entry: str):
    """Decorator: read each call's memory and keep, per signature, the
    largest reading (see the module docstring for the two methods)."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            out, stats = _measure(fn, args, kwargs)
            _record(entry, _sig_of(args, kwargs), stats, 1)
            return out

        wrapper.__name__ = getattr(fn, "__name__", "wrapper")
        wrapper.__wrapped__ = fn
        wrapper._ledger_wrapper = True
        return wrapper

    return deco


def measure_memory(fn: Callable, *args, entry: Optional[str] = None, **kwargs):
    """One reading: call ``fn`` on these arguments and return its stats
    dict. With ``entry`` the reading also lands in the ledger (calls stay
    0, as in the JAX ledger, where the function is compiled and not run).
    Unlike the JAX ledger this runs the function."""
    _, stats = _measure(fn, args, kwargs)
    if entry is not None:
        _record(entry, _sig_of(args, kwargs), stats, 0)
    return stats


def memory_records() -> Dict[str, Dict[str, Any]]:
    """Raw ledger: ``{entry: {"calls": n, "signatures": [stats, ...]}}`` —
    one stats dict per distinct signature."""
    with _LOCK:
        return {
            name: {
                "calls": row["calls"],
                "signatures": [dict(s) for s in row["signatures"].values()],
            }
            for name, row in _ENTRIES.items()
        }


def memory_summary() -> List[Dict[str, object]]:
    """One sorted row per entry with the max over its signatures of every
    byte counter (``peak_temp_bytes`` the headline) and the methods of its
    readings."""
    rows = []
    for name, row in sorted(memory_records().items()):
        stats = row["signatures"]
        rollup = {
            "entry": name,
            "calls": row["calls"],
            "signatures": len(stats),
            "peak_temp_bytes": max((s["temp_bytes"] for s in stats), default=0),
        }
        for key in _STAT_FIELDS[1:]:
            rollup[key] = max((s[key] for s in stats), default=0)
        rollup["method"] = ",".join(sorted({s["method"] for s in stats}))
        rows.append(rollup)
    return rows


def reset_memory_ledger() -> None:
    """Forget all entries."""
    with _LOCK:
        _ENTRIES.clear()
