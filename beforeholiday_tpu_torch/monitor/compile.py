"""Signature gate and counters — counterpart of
``beforeholiday_tpu/monitor/compile.py``.

PyTorch runs eagerly, so nothing recompiles; what stays meaningful is the
number of distinct padded ``(kind, shapes)`` signatures an entry point has
seen. In serving, a signature outside the declared bucket set is a bug
upstream (a bucket table and a scheduler disagreeing), so
``track_compiles(strict=True, max_signatures=N)`` refuses the (N+1)-th
signature with :class:`BucketGateError` before the call runs, exactly as the
reference does.

Unlike the reference, the GATE is per gated function: each engine builds its
own wrappers, so a second engine in one process starts with its own budget.
The COUNTERS roll up by entry name, as the reference's do:
:func:`compile_counts` and :func:`compile_summary` report, for each entry,
the distinct signatures across every live wrapper of that name and their
calls, and :func:`reset_compile_counts` clears those wrappers' signature
sets and call counts (re-arming their gates and warnings).
"""

from __future__ import annotations

import functools
import threading
import warnings
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "BucketGateError",
    "compile_counts",
    "compile_summary",
    "reset_compile_counts",
    "track_compiles",
]

_LOCK = threading.Lock()
# entry name -> the live gated wrappers of that name
_ENTRIES: Dict[str, "weakref.WeakSet"] = {}


class BucketGateError(RuntimeError):
    """A strict-mode entry point was called with a signature beyond its
    declared bucket budget."""


def _leaf_sig(leaf: Any):
    if isinstance(leaf, torch.Tensor) or hasattr(leaf, "shape"):
        return ("array", tuple(leaf.shape), str(leaf.dtype))
    try:
        hash(leaf)
    except TypeError:
        return ("unhashable", type(leaf).__name__)
    return ("static", leaf)


def _sig_of(args: Tuple, kwargs: Optional[Dict[str, Any]] = None):
    """Hashable signature of a call: shape and dtype for every array, the
    value for every hashable static."""
    kwargs = kwargs or {}
    return (tuple(_leaf_sig(a) for a in args),
            tuple((k, _leaf_sig(v)) for k, v in sorted(kwargs.items())))


def track_compiles(entry: str, *, strict: bool = False,
                   max_signatures: Optional[int] = None):
    """Decorator counting the distinct call signatures of ``entry``.

    The wrapper exposes ``signatures`` (the set seen) and ``calls``. With
    ``strict=True`` and ``max_signatures=N``, a call whose signature would
    be the (N+1)-th raises :class:`BucketGateError` before the call, without
    registering the signature; otherwise a second signature warns once."""
    if strict and max_signatures is None:
        raise ValueError("strict=True requires max_signatures")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sig = _sig_of(args, kwargs)
            wrapper.calls += 1
            known = wrapper.signatures
            if sig not in known:
                if strict and len(known) >= max_signatures:
                    raise BucketGateError(
                        f"entry {entry!r}: signature outside the declared "
                        f"bucket set (budget {max_signatures}, already seen "
                        f"{len(known)}): {sig} — pad to a declared bucket or "
                        f"widen the bucket set"
                    )
                known.add(sig)
                if len(known) == 2 and not strict:
                    warnings.warn(
                        f"entry {entry!r} saw a second signature {sig}: "
                        f"pad inputs to a fixed set of shapes",
                        stacklevel=2,
                    )
            return fn(*args, **kwargs)

        wrapper.signatures = set()
        wrapper.calls = 0
        with _LOCK:
            _ENTRIES.setdefault(entry, weakref.WeakSet()).add(wrapper)
        return wrapper

    return deco


def compile_counts() -> Dict[str, Dict[str, int]]:
    """Per-entry counters: ``{entry: {"signatures": n, "calls": m}}`` over
    every live wrapper of the entry's name (``signatures``: the distinct
    ones among them). Entries not called since their last reset are
    left out, as the reference leaves out entries it has not seen."""
    with _LOCK:
        rows = {name: list(ws) for name, ws in _ENTRIES.items()}
    out = {}
    for name, wrappers in rows.items():
        calls = sum(w.calls for w in wrappers)
        if calls:
            sigs = set().union(*(w.signatures for w in wrappers))
            out[name] = {"signatures": len(sigs), "calls": calls}
    return out


def compile_summary() -> List[Dict[str, object]]:
    """One sorted row per called entry, ``{"entry", "signatures", "calls",
    "recompiled"}``."""
    return [
        {"entry": name, "signatures": c["signatures"], "calls": c["calls"],
         "recompiled": c["signatures"] > 1}
        for name, c in sorted(compile_counts().items())
    ]


def reset_compile_counts(entry: Optional[str] = None) -> None:
    """Clear the signature sets and call counts of every wrapper of
    ``entry`` (all entries when None): counting restarts at the next call,
    and a strict gate admits its declared budget afresh."""
    with _LOCK:
        names = [entry] if entry is not None else list(_ENTRIES)
        wrappers = [w for n in names for w in _ENTRIES.get(n, ())]
    for w in wrappers:
        w.signatures.clear()
        w.calls = 0
