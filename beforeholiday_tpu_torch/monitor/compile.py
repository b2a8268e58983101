"""Signature gate — the part of ``beforeholiday_tpu/monitor/compile.py`` the
serving engine needs.

PyTorch runs eagerly, so nothing recompiles; what stays meaningful is the
number of distinct padded ``(kind, shapes)`` signatures an entry point has
seen. In serving, a signature outside the declared bucket set is a bug
upstream (a bucket table and a scheduler disagreeing), so
``track_compiles(strict=True, max_signatures=N)`` refuses the (N+1)-th
signature with :class:`BucketGateError` before the call runs, exactly as the
reference does. Unlike the reference, each gated function keeps its own
counts (no process-wide registry).
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["BucketGateError", "track_compiles"]


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
        return wrapper

    return deco
