"""Search-driven knob autotuner — counterpart of ``beforeholiday_tpu/tune``.

Four pieces:

* :mod:`~beforeholiday_tpu_torch.tune.space` — the declarative
  :class:`KnobSpace` over every default-OFF perf knob (legal values, owning
  layer, mutual-exclusion constraints) and the :data:`UNSET` sentinel;
* :mod:`~beforeholiday_tpu_torch.tune.signature` — stable ``(model
  abstract signature, mesh, ChipSpec)`` tuning keys (the port's own
  digests: see that module);
* :mod:`~beforeholiday_tpu_torch.tune.search` — bounded successive-halving
  search with ledger-costed trials (roofline and memory pruning, per-trial
  compile-counter isolation);
* :mod:`~beforeholiday_tpu_torch.tune.manifest` — the persisted
  ``tune-manifest-v1`` JSON so a re-run is a cache hit with zero trials.

This module also hosts :func:`resolve_knobs` / :func:`resolve_trainer_knobs`
— the integration layer ``amp.initialize(tuned=True)`` and the DDP/ZeRO
constructors call to overlay manifest-tuned values onto their defaults.
Explicit caller kwargs ALWAYS win (the :data:`UNSET` sentinel tells an
omitted kwarg from a passed one); a manifest miss falls back to the shipped
defaults with one structured warning per resolution site.

Import discipline: the eager imports here are stdlib-only (``space``,
``manifest``); ``search``/``signature`` load lazily (PEP 562), so ``from
beforeholiday_tpu_torch.tune import UNSET`` stays cheap from any layer.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from beforeholiday_tpu_torch.tune.manifest import (
    SCHEMA,
    TuningManifest,
    default_path,
)
from beforeholiday_tpu_torch.tune.space import (
    UNSET,
    Knob,
    KnobConstraintError,
    KnobSpace,
    shipped_space,
)

__all__ = [
    "SCHEMA",
    "UNSET",
    "Knob",
    "KnobConstraintError",
    "KnobSpace",
    "TrialRecord",
    "TuneResult",
    "TuningKey",
    "TuningManifest",
    "default_path",
    "resolve_knobs",
    "resolve_trainer_knobs",
    "shipped_space",
    "trial_scope",
    "tune",
    "tuning_key",
]

_LAZY = {
    "tune": ("beforeholiday_tpu_torch.tune.search", "tune"),
    "trial_scope": ("beforeholiday_tpu_torch.tune.search", "trial_scope"),
    "TrialRecord": ("beforeholiday_tpu_torch.tune.search", "TrialRecord"),
    "TuneResult": ("beforeholiday_tpu_torch.tune.search", "TuneResult"),
    "TuningKey": ("beforeholiday_tpu_torch.tune.signature", "TuningKey"),
    "tuning_key": ("beforeholiday_tpu_torch.tune.signature", "tuning_key"),
}


def __getattr__(name: str):  # PEP 562: keep the eager import path light
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


def resolve_knobs(
    kind: str,
    defaults: Mapping[str, Any],
    explicit: Optional[Mapping[str, Any]] = None,
    *,
    tuned: bool = False,
    key: Any = None,
    manifest: Any = None,
    context: Optional[Mapping[str, Any]] = None,
    space: Optional[KnobSpace] = None,
) -> Tuple[Dict[str, Any], str]:
    """Resolve one consumer's knob values; returns ``(config, source)``.

    ``defaults`` names exactly the knobs this consumer owns and their
    shipped defaults; only those keys ever appear in the result. ``explicit``
    carries the kwargs as received — entries equal to :data:`UNSET` were
    omitted by the caller, everything else is an explicit choice and wins
    over any manifest value (even when it merely restates the default).

    With ``tuned=True``, the manifest (a :class:`TuningManifest`, a path, or
    None for the default location) is consulted under ``key``; hits are
    sanitized against ``space`` (default: :func:`shipped_space`) + ``context``
    so a stale entry can never hand the constructor an illegal combination.
    A miss — or ``key=None`` — warns ONCE per ``kind`` and falls back to
    ``defaults``. ``source`` is ``"manifest"``, ``"defaults"``, or
    ``"explicit"`` (untuned path)."""
    from beforeholiday_tpu_torch.utils.logging import warn_once

    resolved = dict(defaults)
    source = "explicit"
    if tuned:
        source = "defaults"
        sp = space if space is not None else shipped_space()
        man = (
            manifest if isinstance(manifest, TuningManifest)
            else TuningManifest(manifest)
        )
        hit = man.lookup(key) if key is not None else None
        if hit is not None:
            clean, _dropped = sp.sanitize(
                hit["config"], context=context, base=defaults
            )
            resolved = clean
            source = "manifest"
        else:
            digest = getattr(key, "digest", key)
            warn_once(
                ("tune.resolve", kind),
                "tune[%s]: no manifest entry for key %s in %s; "
                "falling back to shipped defaults (run tune.tune() with "
                "this signature to populate the manifest)",
                kind,
                digest if digest is not None else "<no tuning key>",
                man.path,
            )
    for name, value in (explicit or {}).items():
        if value is UNSET or name not in resolved:
            continue
        resolved[name] = value
    return resolved, source


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
    """Constructor-side wrapper over :func:`resolve_knobs` — same contract,
    config only (trainers don't surface the source)."""
    config, _source = resolve_knobs(
        kind, defaults, explicit,
        tuned=tuned, key=tuning_key, manifest=manifest, context=context,
    )
    return config
