"""Bounded successive-halving search over a :class:`KnobSpace` — counterpart
of ``beforeholiday_tpu/tune/search.py``.

The cost signal is NOT just wall clock. Every trial runs under a dedicated
ledger entry (``tune.trial<N>``) so the roofline/memory ledgers can argue
about it:

* a config whose roofline row classifies **compute-bound** and whose first
  timing is already slower than the incumbent best is pruned — more data
  cannot save it (a memory- or comms-bound config might still win at a
  longer horizon via overlap, so only the compute-bound case is safe to
  cut);
* a config whose memory ledger shows ``peak_temp_bytes`` over
  ``memory_budget_bytes`` is pruned before it ever OOMs a real chip.

Trial isolation: each trial runs inside :func:`trial_scope`, which
collects garbage before the trial, then resets the trial's OWN
``track_compiles`` entry afterwards (``reset_compile_counts(entry)``).
Trials therefore never accumulate recompile warnings across configs and
never push a strict bucket-gated entry over its budget. (The JAX scope also
clears the guard's probe cache; the port has no probe: its kernel wrappers
launch or raise.)

On the card, a ``trial_fn`` times its ``steps`` with CUDA events after its
warm-up, with one synchronize a trial (``chip_smoke.py``'s ``tune_card``
does); the search itself only reads the seconds it returns.

Budgeting: ``max_trials`` bounds trial_fn invocations; ``steps_per_trial``
is the rung-0 horizon, doubled (``eta``) each promotion rung;
``iters`` timings per trial with min-of-iters (the bench meter's
convention — the minimum is the least-noise estimator on a shared host).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
from typing import Any, Callable, Dict, List, Mapping, Optional

from beforeholiday_tpu_torch.tune.manifest import TuningManifest
from beforeholiday_tpu_torch.tune.space import KnobSpace

__all__ = [
    "TrialRecord",
    "TuneResult",
    "trial_scope",
    "tune",
]

TRIAL_ENTRY_PREFIX = "tune.trial"


@dataclasses.dataclass
class TrialRecord:
    """One executed (or pruned) trial: a config at one rung horizon."""

    config: Dict[str, Any]
    cost_s: Optional[float]  # per-step seconds; None when pruned
    steps: int
    entry: str
    pruned: Optional[str] = None  # prune reason, None = completed
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TuneResult:
    config: Dict[str, Any]
    cost_s: Optional[float]
    trials: int
    cache_hit: bool
    key: Any = None
    records: List[TrialRecord] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def trial_scope(entry: str):
    """Per-trial isolation: a gc pass going in; a scoped ``track_compiles``
    reset (this entry ONLY — other entries' counters and armed warnings
    survive) and another gc pass coming out. A tuner running the same entry
    name across trials with different shapes would otherwise fire the
    recompile warn-once or, on a strict bucket-gated entry, raise
    ``BucketGateError`` for what is really a sequence of independent
    programs."""
    from beforeholiday_tpu_torch.monitor.compile import reset_compile_counts

    gc.collect()
    try:
        yield entry
    finally:
        reset_compile_counts(entry)
        gc.collect()


# ---------------------------------------------------------------- evidence
def _entry_peak_temp_bytes(entry: str) -> Optional[int]:
    from beforeholiday_tpu_torch.monitor import memory_summary

    for row in memory_summary():
        if row["entry"] == entry:
            return row["peak_temp_bytes"]
    return None


def _entry_bound(entry: str, chip: Any = None) -> str:
    from beforeholiday_tpu_torch.monitor import roofline_summary

    for row in roofline_summary(chip):
        if row["entry"] == entry:
            return row["bound"]
    return "unknown"


def _run_trial(
    trial_fn: Callable[[Dict[str, Any], int, str], float],
    config: Dict[str, Any],
    steps: int,
    iters: int,
    entry: str,
    best_cost: Optional[float],
    memory_budget_bytes: Optional[int],
    chip: Any,
) -> TrialRecord:
    from beforeholiday_tpu_torch.monitor import record_wall_time

    evidence: Dict[str, Any] = {}
    pruned: Optional[str] = None
    per_step: List[float] = []
    with trial_scope(entry):
        for i in range(max(1, iters)):
            seconds = trial_fn(dict(config), steps, entry)
            per_step.append(seconds / steps)
            if i > 0:
                continue
            # ledger evidence from the first iteration: the trial_fn's
            # measure_costs/measure_memory rows joined with this wall time
            try:
                record_wall_time(entry, seconds, steps=steps)
            except ValueError:
                pass  # a zero/negative clock reading carries no evidence
            peak = _entry_peak_temp_bytes(entry)
            if peak is not None:
                evidence["peak_temp_bytes"] = peak
            bound = _entry_bound(entry, chip)
            evidence["bound"] = bound
            if (
                memory_budget_bytes is not None
                and peak is not None
                and peak > memory_budget_bytes
            ):
                pruned = "peak_temp_bytes_over_budget"
                break
            if (
                bound == "compute"
                and best_cost is not None
                and per_step[0] > best_cost
            ):
                pruned = "compute_bound_and_slower"
                break
    cost = min(per_step) if pruned is None else None
    return TrialRecord(
        config=dict(config), cost_s=cost, steps=steps, entry=entry,
        pruned=pruned, evidence=evidence,
    )


def _dedup(configs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    seen = set()
    out = []
    for cfg in configs:
        sig = tuple(sorted(cfg.items(), key=lambda kv: kv[0]))
        if sig in seen:
            continue
        seen.add(sig)
        out.append(dict(cfg))
    return out


def tune(
    trial_fn: Callable[[Dict[str, Any], int, str], float],
    space: KnobSpace,
    key: Any = None,
    *,
    manifest: Any = None,
    context: Optional[Mapping[str, Any]] = None,
    candidates: Optional[List[Dict[str, Any]]] = None,
    max_trials: int = 16,
    steps_per_trial: int = 4,
    iters: int = 2,
    eta: int = 2,
    memory_budget_bytes: Optional[int] = None,
    chip: Any = None,
) -> TuneResult:
    """Search ``space`` for the fastest config of ``trial_fn``.

    ``trial_fn(config, steps, entry)`` runs ``steps`` training steps under
    the given config and returns the measured wall seconds for those steps
    (excluding compilation — warm up inside). Register analytic costs under
    ``entry`` (``measure_costs``/``measure_memory`` with ``entry=entry``) to
    arm the roofline/memory pruners; the search joins its own wall clock to
    that entry either way.

    ``key`` + ``manifest`` (a :class:`TuningManifest`, a path, or None for
    no persistence) make the search cacheable: a hit returns immediately
    with ``trials == 0`` and ``cache_hit=True``; a completed search stores
    its winner. ``candidates`` overrides the default candidate set (the
    space defaults + every legal single-knob deviation)."""
    if max_trials < 1:
        raise ValueError(f"max_trials must be >= 1, got {max_trials}")
    man: Optional[TuningManifest] = None
    if manifest is not None:
        man = (
            manifest if isinstance(manifest, TuningManifest)
            else TuningManifest(manifest)
        )
    if man is not None and key is not None:
        hit = man.lookup(key)
        if hit is not None:
            return TuneResult(
                config=dict(hit["config"]),
                cost_s=hit.get("best_cost_s"),
                trials=0, cache_hit=True, key=key, records=[],
            )

    if candidates is None:
        candidates = [space.defaults()] + [
            cfg for _, _, cfg in space.single_knob_configs(context=context)
        ]
    current = _dedup(candidates)
    if not current:
        raise ValueError("empty candidate set")
    for cfg in current:
        space.validate(cfg, context)

    trials = 0
    records: List[TrialRecord] = []
    best_cost: Optional[float] = None
    rung_steps = max(1, int(steps_per_trial))
    while current and trials < max_trials:
        scored: List[TrialRecord] = []
        for cfg in current:
            if trials >= max_trials:
                break
            entry = f"{TRIAL_ENTRY_PREFIX}{trials}"
            trials += 1
            rec = _run_trial(
                trial_fn, cfg, rung_steps, iters, entry, best_cost,
                memory_budget_bytes, chip,
            )
            records.append(rec)
            if rec.cost_s is not None:
                scored.append(rec)
                if best_cost is None or rec.cost_s < best_cost:
                    best_cost = rec.cost_s
        if not scored:
            break
        scored.sort(key=lambda r: r.cost_s)
        keep = max(1, math.ceil(len(scored) / eta))
        survivors = [r.config for r in scored[:keep]]
        if len(survivors) == 1 and len(current) == 1:
            break  # converged: the lone survivor re-ran at this horizon
        current = survivors
        rung_steps *= max(2, int(eta))
        if len(survivors) == 1:
            break  # a single winner after halving — done

    completed = [r for r in records if r.cost_s is not None]
    if completed:
        best = min(completed, key=lambda r: r.cost_s)
        best_config, best_cost_s = best.config, best.cost_s
    else:
        # every trial pruned (or trial_fn never completed): fall back to the
        # first candidate — for the default candidate set, the shipped
        # defaults — rather than inventing a winner
        best_config, best_cost_s = dict(_dedup(candidates)[0]), None

    if man is not None and key is not None and completed:
        man.store(key, best_config, cost_s=best_cost_s, trials=trials)
    return TuneResult(
        config=dict(best_config), cost_s=best_cost_s, trials=trials,
        cache_hit=False, key=key, records=records,
    )
