"""Roofline / MFU ledger — counterpart of
``beforeholiday_tpu/monitor/roofline.py``: analytic FLOPs and bytes per
tracked entry, joined with measured wall time into attribution numbers.

The JAX ledger reads XLA's AOT ``cost_analysis()`` (or walks the jaxpr when
the backend omits it). Eager PyTorch has neither, so the port counts while
the entry runs: the first call of each new signature runs under
``torch.utils.flop_counter.FlopCounterMode``, which books each dispatcher
op by its closed form (``aten.mm`` and ``addmm`` 2·M·N·K, ``bmm``,
convolutions, ``_scaled_mm``). The hand-written kernels are custom ops
whose internals the counter does not see; each books its own closed form
(``ops/attention.py``: K2's ``flash_fwd`` 4·BH·Sq·Sk·D and K4's
``flash_bwd`` 8·BH·Sq·Sk·D, halved when causal, the dots of the attention
and of its backward as the JAX package counts them). The norms, the
optimizer kernels and elementwise ops count nothing, where JAX's jaxpr
walk gives reductions and elementwise ops one flop an element: the
``by_primitive`` rows say what was counted. Bytes follow JAX's definition:
the entry's tensor inputs plus outputs (``numel * element_size`` each, a
lower bound). A recompute (``remat``) books its products again, as they
run again.

FLOPs alone are not attribution — they need wall time. Timing is the
CALLER's job (this module adds no device sync): measure a step however you
already do (CUDA events, span wall-times) and hand the seconds to
:func:`record_wall_time`, or let :func:`join_spans` pull durations for
spans named after tracked entries off a trace recorder.
``roofline_summary`` then joins analytic work with measured time against
a registrable :class:`ChipSpec`:

* ``mfu``       — flops / second / peak_tflops;
* ``bw_util``   — bytes / second / hbm_gbs;
* ``bound``     — compute / memory (arithmetic intensity vs the ridge
  point) or comms (recorded comms time dominates the step).

The registry holds the H100 (NVIDIA's data sheet, SXM, dense: 989 TFLOP/s
bf16 and fp16, 1,979 fp8, 3,350 GB/s), named as ``nvidia-smi`` and
``torch.cuda.get_device_name`` name the card, and the default on a CUDA
device; and a CPU proxy, the default without a card. A card the registry
does not know raises rather than being compared with another card's peak.

:func:`perf_report` is the one-call rollup: per-entry ``<entry>_mfu`` /
``<entry>_bw_util`` keys plus the overlap and straggler numbers from
:mod:`beforeholiday_tpu_torch.monitor.overlap` and the dispatch, comms and
compile summaries.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from beforeholiday_tpu_torch.monitor.compile import _sig_of
from beforeholiday_tpu_torch.monitor.memory import _tensors

__all__ = [
    "ChipSpec",
    "chip_specs",
    "estimate_costs",
    "get_chip_spec",
    "join_spans",
    "measure_costs",
    "perf_report",
    "record_wall_time",
    "register_chip_spec",
    "reset_roofline_ledger",
    "roofline_records",
    "roofline_summary",
    "track_costs",
]


# ------------------------------------------------------------------ chip spec
@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers utilization is measured against. ``peak_tflops`` is the
    dense-matmul peak for the dtype you train in; ``hbm_gbs`` is peak memory
    bandwidth in GB/s. ``fp8_peak_tflops`` is the peak the FLOPs booked as
    ``fp8_flops`` are measured against (O6 GEMMs); None means twice the
    dense peak."""

    name: str
    peak_tflops: float
    hbm_gbs: float
    fp8_peak_tflops: Optional[float] = None

    @property
    def ridge_flops_per_byte(self) -> float:
        """Arithmetic intensity at which the roofline bends: entries above it
        are compute-bound, below it memory-bound."""
        return (self.peak_tflops * 1e12) / (self.hbm_gbs * 1e9)

    @property
    def fp8_peak(self) -> float:
        """Effective fp8 peak in TFLOP/s (2x dense peak unless overridden)."""
        return (
            self.fp8_peak_tflops
            if self.fp8_peak_tflops is not None
            else 2.0 * self.peak_tflops
        )


_SPECS_LOCK = threading.Lock()
_CHIP_SPECS: Dict[str, ChipSpec] = {}

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit; a
# card set below it runs slower under load, which the MFU then shows
H100 = ChipSpec("NVIDIA H100 80GB HBM3", peak_tflops=989.0, hbm_gbs=3350.0,
                fp8_peak_tflops=1979.0)
# so that a host run gives finite numbers instead of ~0 against a card's peak
_DEFAULT_CPU = ChipSpec("cpu_proxy", peak_tflops=0.2, hbm_gbs=40.0)


def register_chip_spec(
    spec: Optional[ChipSpec] = None,
    *,
    name: Optional[str] = None,
    peak_tflops: Optional[float] = None,
    hbm_gbs: Optional[float] = None,
    fp8_peak_tflops: Optional[float] = None,
) -> ChipSpec:
    """Register (or overwrite) a chip spec by name. Pass a :class:`ChipSpec`
    or the fields as keywords. Returns the registered spec."""
    if spec is None:
        if name is None or peak_tflops is None or hbm_gbs is None:
            raise ValueError(
                "register_chip_spec needs a ChipSpec or all of "
                "name/peak_tflops/hbm_gbs"
            )
        spec = ChipSpec(
            str(name), float(peak_tflops), float(hbm_gbs),
            float(fp8_peak_tflops) if fp8_peak_tflops is not None else None,
        )
    if spec.peak_tflops <= 0 or spec.hbm_gbs <= 0 or spec.fp8_peak <= 0:
        raise ValueError(f"chip peaks must be positive, got {spec}")
    with _SPECS_LOCK:
        _CHIP_SPECS[spec.name] = spec
    return spec


def get_chip_spec(name: str) -> ChipSpec:
    with _SPECS_LOCK:
        if name not in _CHIP_SPECS:
            raise KeyError(
                f"unknown chip spec {name!r}; registered: "
                f"{sorted(_CHIP_SPECS)} (add via register_chip_spec)"
            )
        return _CHIP_SPECS[name]


def chip_specs() -> Dict[str, ChipSpec]:
    with _SPECS_LOCK:
        return dict(_CHIP_SPECS)


def _resolve_chip(chip: Union[ChipSpec, str, None]) -> ChipSpec:
    if isinstance(chip, ChipSpec):
        return chip
    if isinstance(chip, str):
        return get_chip_spec(chip)
    # default: the card's own spec, the CPU proxy without a card — never a
    # host run against a card's peak, nor one card against another's
    if torch.cuda.is_available():
        return get_chip_spec(torch.cuda.get_device_name(0))
    return _DEFAULT_CPU


register_chip_spec(H100)
register_chip_spec(_DEFAULT_CPU)


# ------------------------------------------------------------ the counting
def _tensor_bytes(obj) -> float:
    """JAX's bytes: every tensor's ``numel * element_size``."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(obj)))


def _mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·M·N·K. PyTorch's own formula takes the ``.dtype`` overload's
    ``out_dtype`` (a further positional argument, the card's bf16 x bf16 ->
    fp32 GEMM of ``ops/dense.py``) for its ``out_shape`` and fails."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _addmm_flops(bias_shape, a_shape, b_shape, *args, out_shape=None,
                 **kwargs) -> int:
    return _mm_flops(a_shape, b_shape)


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·B·M·N·K, the ``.dtype`` overload too (``moe/experts.py``'s grouped
    GEMM on the card)."""
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


_FORMULAS = {torch.ops.aten.mm: _mm_flops, torch.ops.aten.addmm: _addmm_flops,
             torch.ops.aten.bmm: _bmm_flops}


def _run_counted(fn: Callable, args, kwargs):
    """``(result, costs)``: one call of ``fn`` under ``FlopCounterMode``."""
    with FlopCounterMode(display=False, custom_mapping=_FORMULAS) as counter:
        out = fn(*args, **kwargs)
    by_prim = {str(op): float(n)
               for op, n in counter.get_flop_counts().get("Global", {}).items()}
    costs = {
        "flops": float(counter.get_total_flops()),
        "bytes_accessed": _tensor_bytes((args, kwargs)) + _tensor_bytes(out),
        "by_primitive": dict(sorted(by_prim.items(), key=lambda kv: -kv[1])),
        "method": "flop_counter",
    }
    return out, costs


def estimate_costs(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Count ``fn``'s work on these arguments: ``{"flops",
    "bytes_accessed", "by_primitive", "method"}``. Unlike JAX's abstract
    trace this RUNS ``fn`` once (eager PyTorch has no trace), so pass
    arguments it may consume."""
    # unwrap the ledgers' own decorators, never a remat or user wrapper
    while getattr(fn, "_ledger_wrapper", False):
        fn = fn.__wrapped__
    return _run_counted(fn, args, kwargs)[1]


# ------------------------------------------------------------------- ledger
_LOCK = threading.Lock()
# entry -> {"signatures": {sig: {"costs": dict, "first_call": int}},
#           "calls": int, "seconds": float, "timed_steps": int,
#           "comms_seconds": float, "flops_override": float|None,
#           "fp8_flops_override": float|None, "bytes_override": float|None}
_ENTRIES: Dict[str, Dict[str, Any]] = {}


def _entry_row(entry: str) -> Dict[str, Any]:
    # caller holds _LOCK
    return _ENTRIES.setdefault(entry, {
        "signatures": {}, "calls": 0,
        "seconds": 0.0, "timed_steps": 0, "comms_seconds": 0.0,
        "flops_override": None, "fp8_flops_override": None,
        "bytes_override": None,
    })


def _mirror_to_trace(entry: str, costs: Optional[Dict[str, Any]]) -> None:
    if costs is None:
        return
    from beforeholiday_tpu_torch.monitor.trace import active_recorder

    rec = active_recorder()
    if rec is not None:
        rec.instant(f"costs:{entry}", args={
            "flops": costs["flops"],
            "bytes_accessed": costs["bytes_accessed"],
            "method": costs["method"],
        })


def track_costs(entry: str):
    """Decorator: record FLOPs and bytes per signature. The first call of
    each new signature is counted as it runs (``FlopCounterMode``: a
    Python dispatch per op, that call only); later calls run bare."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            sig = _sig_of(args, kwargs)
            with _LOCK:
                row = _entry_row(entry)
                row["calls"] += 1
                known = sig in row["signatures"]
                calls = row["calls"]
            if known:
                return fn(*args, **kwargs)
            out, costs = _run_counted(fn, args, kwargs)
            with _LOCK:
                rec = _entry_row(entry)["signatures"].setdefault(
                    sig, {"costs": costs, "first_call": calls})
            _mirror_to_trace(entry, rec["costs"])
            return out

        wrapper.__name__ = getattr(fn, "__name__", "wrapper")
        wrapper.__wrapped__ = fn
        wrapper._ledger_wrapper = True
        return wrapper

    return deco


def measure_costs(
    fn: Callable, *args, entry: Optional[str] = None, **kwargs
) -> Optional[Dict[str, Any]]:
    """One count: run ``fn`` on these arguments under the counter and return
    its cost dict. With ``entry`` the costs also land in the ledger (calls
    stay 0, as in the JAX ledger)."""
    costs = estimate_costs(fn, *args, **kwargs)
    if entry is not None:
        sig = _sig_of(args, kwargs)
        with _LOCK:
            _entry_row(entry)["signatures"].setdefault(
                sig, {"costs": costs, "first_call": 0})
        _mirror_to_trace(entry, costs)
    return costs


def record_wall_time(
    entry: str,
    seconds: float,
    *,
    steps: int = 1,
    flops: Optional[float] = None,
    fp8_flops: Optional[float] = None,
    bytes_accessed: Optional[float] = None,
    comms_seconds: float = 0.0,
) -> None:
    """Attribute measured wall time to an entry — the join point between the
    caller's timing and the analytic costs.

    ``seconds`` covers ``steps`` executions. ``flops``/``bytes_accessed``
    are optional PER-STEP overrides for callers that know the count in
    closed form (6·N·tokens); they take precedence over the tracked costs.
    ``fp8_flops`` is the per-step share executed as fp8 matmuls, measured
    against the chip's fp8 peak — pass the split (``flops`` excluding it).
    ``comms_seconds`` (over the whole measurement) feeds the comms-bound
    classification. Host floats in, host floats stored."""
    if seconds < 0 or steps < 1:
        raise ValueError(f"need seconds >= 0 and steps >= 1, got "
                         f"{seconds}/{steps}")
    with _LOCK:
        row = _entry_row(entry)
        row["seconds"] += float(seconds)
        row["timed_steps"] += int(steps)
        row["comms_seconds"] += float(comms_seconds)
        if flops is not None:
            row["flops_override"] = float(flops)
        if fp8_flops is not None:
            row["fp8_flops_override"] = float(fp8_flops)
        if bytes_accessed is not None:
            row["bytes_override"] = float(bytes_accessed)


def join_spans(events: Optional[List[Dict[str, Any]]] = None) -> int:
    """Pull wall time off a trace timeline: every complete ``B``/``E`` span
    whose name matches a tracked entry contributes its duration (one step
    per span) via :func:`record_wall_time`. ``events`` defaults to the active
    recorder's. Returns the number of spans joined. These are host spans:
    a span around asynchronous device work measures the host's time unless
    it ends in a synchronize."""
    if events is None:
        from beforeholiday_tpu_torch.monitor.trace import active_recorder

        rec = active_recorder()
        if rec is None:
            return 0
        events = rec.events()
    with _LOCK:
        tracked = set(_ENTRIES)
    from beforeholiday_tpu_torch.monitor.overlap import span_intervals

    joined = 0
    for iv in span_intervals(events):
        if iv["name"] in tracked:
            record_wall_time(
                iv["name"], (iv["end"] - iv["start"]) / 1e6, steps=1
            )
            joined += 1
    return joined


# ------------------------------------------------------------------- queries
def roofline_records() -> Dict[str, Dict[str, Any]]:
    """Raw ledger snapshot (JSON-ready)."""
    with _LOCK:
        out = {}
        for name, row in _ENTRIES.items():
            out[name] = {
                "calls": row["calls"],
                "seconds": row["seconds"],
                "timed_steps": row["timed_steps"],
                "comms_seconds": row["comms_seconds"],
                "flops_override": row["flops_override"],
                "fp8_flops_override": row["fp8_flops_override"],
                "bytes_override": row["bytes_override"],
                "signatures": [
                    dict(r["costs"]) if r["costs"] is not None else None
                    for r in row["signatures"].values()
                ],
            }
        return out


def roofline_summary(
    chip: Union[ChipSpec, str, None] = None,
) -> List[Dict[str, Any]]:
    """One row per entry: analytic work joined with recorded wall time
    against ``chip`` (default: the card's spec, the CPU proxy without a
    card). Entries without recorded time still classify by arithmetic
    intensity but carry ``mfu``/``bw_util`` of None."""
    spec = _resolve_chip(chip)
    ridge = spec.ridge_flops_per_byte
    rows = []
    for name, row in sorted(roofline_records().items()):
        costs = [c for c in row["signatures"] if c is not None]
        flops = row["flops_override"]
        method = "override" if flops is not None else None
        if flops is None:
            sig_flops = [c["flops"] for c in costs if c["flops"] is not None]
            flops = max(sig_flops, default=None)
            if flops is not None:
                method = next(
                    c["method"] for c in costs if c["flops"] is not None
                )
        nbytes = row["bytes_override"]
        if nbytes is None:
            sig_bytes = [
                c["bytes_accessed"] for c in costs
                if c["bytes_accessed"] is not None
            ]
            nbytes = max(sig_bytes, default=None)

        fp8_flops = row["fp8_flops_override"]

        steps = row["timed_steps"]
        sec = row["seconds"] / steps if steps else None
        comms_frac = (
            row["comms_seconds"] / row["seconds"] if row["seconds"] else None
        )
        mfu = None
        bw_util = None
        if sec and (flops is not None or fp8_flops is not None):
            # each precision class utilizes its own peak
            mfu = (
                (flops or 0.0) / spec.peak_tflops
                + (fp8_flops or 0.0) / spec.fp8_peak
            ) / sec / 1e12
        if sec and nbytes is not None:
            bw_util = nbytes / sec / 1e9 / spec.hbm_gbs
        total_flops = (
            (flops or 0.0) + (fp8_flops or 0.0)
            if flops is not None or fp8_flops is not None
            else None
        )
        intensity = (
            total_flops / nbytes if total_flops is not None and nbytes else None
        )
        if comms_frac is not None and comms_frac >= 0.5:
            bound = "comms"
        elif intensity is not None:
            bound = "compute" if intensity >= ridge else "memory"
        else:
            bound = "unknown"
        rows.append({
            "entry": name,
            "calls": row["calls"],
            "signatures": len(row["signatures"]),
            "method": method,
            "flops_per_step": flops,
            "fp8_flops_per_step": fp8_flops,
            "bytes_per_step": nbytes,
            "seconds_per_step": sec,
            "timed_steps": steps,
            "comms_fraction": comms_frac,
            "mfu": mfu,
            "bw_util": bw_util,
            "intensity_flops_per_byte": intensity,
            "ridge_flops_per_byte": ridge,
            "bound": bound,
        })
    return rows


def reset_roofline_ledger() -> None:
    """Forget all entries (costs and recorded times). Tracked functions
    count again on their next call."""
    with _LOCK:
        _ENTRIES.clear()


# ---------------------------------------------------------------- the report
def perf_report(
    *,
    chip: Union[ChipSpec, str, None] = None,
    events: Optional[List[Dict[str, Any]]] = None,
    step_span: str = "step",
) -> Dict[str, Any]:
    """The one-call attribution rollup: roofline rows flattened into
    ``<entry>_mfu`` / ``<entry>_bw_util`` keys, the measured
    ``overlap_fraction`` and ``rank_skew_*`` from the timeline (``events``
    defaults to the active trace recorder's), and the dispatch, comms and
    compile summaries."""
    from beforeholiday_tpu_torch.monitor import overlap as _overlap
    from beforeholiday_tpu_torch.monitor.comms import comms_summary
    from beforeholiday_tpu_torch.monitor.compile import compile_summary
    from beforeholiday_tpu_torch.monitor.counters import dispatch_summary

    spec = _resolve_chip(chip)
    rows = roofline_summary(chip=spec)
    report: Dict[str, Any] = {
        "chip": dataclasses.asdict(spec),
        "entries": rows,
    }
    for r in rows:
        if r["mfu"] is not None:
            report[f"{r['entry']}_mfu"] = round(r["mfu"], 6)
        if r["bw_util"] is not None:
            report[f"{r['entry']}_bw_util"] = round(r["bw_util"], 6)

    if events is None:
        from beforeholiday_tpu_torch.monitor.trace import active_recorder

        rec = active_recorder()
        events = rec.events() if rec is not None else None
    if events:
        ov = _overlap.overlap_report(events, step_span=step_span)
        report["overlap"] = {
            "steps": len(ov["steps"]),
            "comms_us": ov["comms_us"],
            "hidden_us": ov["hidden_us"],
            "exposed_us": ov["exposed_us"],
        }
        if ov["overlap_fraction"] is not None:
            report["overlap_fraction"] = ov["overlap_fraction"]
        stragglers = _overlap.straggler_report(events)
        if stragglers:
            worst = stragglers[0]
            report["rank_skew_span"] = worst["name"]
            report["rank_skew_us"] = worst["skew_us"]
            report["rank_skew_rel"] = worst["skew_rel"]
            report["stragglers"] = stragglers

    report["dispatch"] = dispatch_summary()
    report["comms"] = comms_summary()
    report["compile"] = compile_summary()
    return report
