"""Knob resolution — the part of ``beforeholiday_tpu/tune`` that the DDP
constructor calls: the :data:`UNSET` sentinel and
:func:`resolve_trainer_knobs`.

Untuned (``tuned=False``), a consumer's knobs resolve as the JAX package
resolves them: every kwarg the caller passed wins, every omitted one
(:data:`UNSET`) takes the shipped default. ``tuned=True`` needs the
autotuner's manifest and search, which are not ported yet, and raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

__all__ = ["UNSET", "resolve_trainer_knobs"]


class _Unset:
    """Sentinel for "the caller did not pass this kwarg", distinct from
    None, which is a legal value of several knobs (``bucket_bytes=None``
    means one collective per arena)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNSET"

    def __bool__(self) -> bool:
        return False


UNSET = _Unset()


def resolve_trainer_knobs(
    kind: str,
    defaults: Mapping[str, Any],
    explicit: Optional[Mapping[str, Any]] = None,
    *,
    tuned: bool = False,
    tuning_key: Any = None,
    manifest: Any = None,
    context: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """``defaults`` overlaid with the entries of ``explicit`` that are not
    :data:`UNSET` (only the keys ``defaults`` names). ``tuned=True`` raises
    ``NotImplementedError``: the autotuner (``tune.space``, ``search``,
    ``manifest``) is not ported yet."""
    if tuned:
        raise NotImplementedError(
            f"tuned=True ({kind}) needs the autotuner (beforeholiday_tpu.tune: "
            "the knob space, search and manifest), which is not ported yet; "
            "pass the knobs explicitly")
    resolved = dict(defaults)
    for name, value in (explicit or {}).items():
        if value is UNSET or name not in resolved:
            continue
        resolved[name] = value
    return resolved
