"""Declarative knob space over the default-OFF perf knobs — counterpart of
``beforeholiday_tpu/tune/space.py``, the same knobs, values, defaults,
layers and constraints.

Every performance mechanism ships behind a default-OFF knob (remat policy,
bucket sizes, wire compression, backward-time overlap, the quantized O6
tier, ...) whose best setting depends on model × mesh × chip. This module
names that space ONCE: each :class:`Knob` declares its legal values, the
layer that consumes it, and the constraints under which a non-default value
is even meaningful (``collective_matmul`` requires sequence parallelism,
``bucket_bytes_dcn`` requires ``hierarchical=True``). The search
(:mod:`beforeholiday_tpu_torch.tune.search`) enumerates candidates from this
declaration, and the manifest resolution (:func:`beforeholiday_tpu_torch.tune
.resolve_knobs`) uses :meth:`KnobSpace.sanitize` so a stale manifest entry
can never hand a constructor an illegal combination.

Host-side metadata only — no torch import, no device work. :data:`UNSET`
lives here: the DDP, ZeRO-2 and ZeRO-3 constructors import it through
``beforeholiday_tpu_torch.tune``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "UNSET",
    "Knob",
    "KnobConstraintError",
    "KnobSpace",
    "shipped_space",
]


class _Unset:
    """Sentinel for 'the caller did not pass this kwarg' — distinct from
    ``None``, which is a legal value for several knobs (``bucket_bytes=None``
    means monolithic reduction). Constructors use it so the tuned-resolution
    path can tell an explicit kwarg (always wins) from an omitted one."""

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


class KnobConstraintError(ValueError):
    """A knob configuration violates the space's declared constraints."""


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable knob: legal values, owning layer, and activation
    constraints.

    ``requires`` lists ``(other_knob, required_value)`` pairs that must hold
    whenever THIS knob is active (set to a non-default value).
    ``requires_context`` lists caller-context flags (e.g. ``"two_level"``,
    ``"sequence_parallel"``) that must be truthy for a non-default value to
    be legal — facts about the trainer/mesh the space itself cannot see."""

    name: str
    values: Tuple[Any, ...]
    default: Any
    layer: str
    requires: Tuple[Tuple[str, Any], ...] = ()
    requires_context: Tuple[str, ...] = ()
    doc: str = ""

    def __post_init__(self):
        if self.default not in self.values:
            raise ValueError(
                f"knob {self.name!r}: default {self.default!r} not among "
                f"legal values {self.values!r}"
            )


class KnobSpace:
    """An ordered collection of :class:`Knob` with constraint checking."""

    def __init__(self, knobs: Iterable[Knob]):
        self.knobs: Dict[str, Knob] = {}
        for knob in knobs:
            if knob.name in self.knobs:
                raise ValueError(f"duplicate knob {knob.name!r}")
            self.knobs[knob.name] = knob
        for knob in self.knobs.values():
            for other, req in knob.requires:
                if other not in self.knobs:
                    raise ValueError(
                        f"knob {knob.name!r} requires unknown knob {other!r}"
                    )
                if req not in self.knobs[other].values:
                    raise ValueError(
                        f"knob {knob.name!r} requires {other}={req!r}, not a "
                        f"legal value of {other!r}"
                    )

    def __contains__(self, name: str) -> bool:
        return name in self.knobs

    def __getitem__(self, name: str) -> Knob:
        return self.knobs[name]

    def __len__(self) -> int:
        return len(self.knobs)

    def names(self) -> List[str]:
        return list(self.knobs)

    def defaults(self) -> Dict[str, Any]:
        """The all-defaults configuration — the shipped behavior."""
        return {name: knob.default for name, knob in self.knobs.items()}

    def subset(self, names: Iterable[str]) -> "KnobSpace":
        """A new space over only ``names`` (constraint targets must ride
        along or the subset raises via the constructor's closure check)."""
        picked = []
        for name in names:
            if name not in self.knobs:
                raise KeyError(f"unknown knob {name!r}")
            picked.append(self.knobs[name])
        return KnobSpace(picked)

    # ------------------------------------------------------------ validation
    def violations(
        self,
        config: Mapping[str, Any],
        context: Optional[Mapping[str, Any]] = None,
    ) -> List[str]:
        """Human-readable list of everything wrong with ``config`` (empty =
        legal). Knobs absent from ``config`` are assumed at their default."""
        ctx = context or {}
        out: List[str] = []
        for name, value in config.items():
            knob = self.knobs.get(name)
            if knob is None:
                out.append(f"unknown knob {name!r}")
                continue
            if value not in knob.values:
                out.append(
                    f"{name}={value!r} not among legal values {knob.values!r}"
                )
        for name, knob in self.knobs.items():
            value = config.get(name, knob.default)
            if value == knob.default or value not in knob.values:
                continue  # inactive (or already flagged illegal above)
            for flag in knob.requires_context:
                if not ctx.get(flag):
                    out.append(
                        f"{name}={value!r} requires context {flag!r} "
                        f"(not available here)"
                    )
            for other, req in knob.requires:
                actual = config.get(other, self.knobs[other].default)
                if actual != req:
                    out.append(
                        f"{name}={value!r} requires {other}={req!r} "
                        f"(got {actual!r})"
                    )
        return out

    def validate(
        self,
        config: Mapping[str, Any],
        context: Optional[Mapping[str, Any]] = None,
    ) -> None:
        bad = self.violations(config, context)
        if bad:
            raise KnobConstraintError("; ".join(bad))

    def is_legal(
        self,
        config: Mapping[str, Any],
        context: Optional[Mapping[str, Any]] = None,
    ) -> bool:
        return not self.violations(config, context)

    def sanitize(
        self,
        values: Mapping[str, Any],
        *,
        context: Optional[Mapping[str, Any]] = None,
        base: Optional[Mapping[str, Any]] = None,
    ) -> Tuple[Dict[str, Any], List[str]]:
        """Overlay ``values`` onto ``base`` (default: the space defaults),
        dropping anything illegal, and return ``(clean_config, dropped)``.

        This is the manifest-resolution guard: a stale or cross-context
        manifest entry (e.g. ``hierarchical=True`` recorded on a two-level
        mesh, resolved on a flat one) reverts to the caller's default instead
        of blowing up the constructor. Only keys present in ``base`` are
        considered when ``base`` is given — a trainer that owns three knobs
        resolves exactly those three."""
        base_cfg = dict(self.defaults() if base is None else base)
        out = dict(base_cfg)
        dropped: List[str] = []
        for name, value in values.items():
            knob = self.knobs.get(name)
            if knob is None or name not in base_cfg:
                dropped.append(name)
                continue
            if value not in knob.values:
                dropped.append(name)
                continue
            out[name] = value
        # iterate to a fixpoint: dropping a knob can invalidate a dependent
        # (bucket_bytes_dcn loses its footing when hierarchical reverts)
        changed = True
        while changed:
            changed = False
            for name in list(out):
                knob = self.knobs.get(name)
                if knob is None or out[name] == knob.default:
                    continue
                bad = any(
                    not (context or {}).get(flag)
                    for flag in knob.requires_context
                ) or any(
                    out.get(other, self.knobs[other].default) != req
                    for other, req in knob.requires
                )
                if bad and out[name] != base_cfg[name]:
                    out[name] = base_cfg[name]
                    dropped.append(name)
                    changed = True
        return out, dropped

    # ------------------------------------------------------------ enumeration
    def single_knob_configs(
        self,
        context: Optional[Mapping[str, Any]] = None,
    ) -> List[Tuple[str, Any, Dict[str, Any]]]:
        """Every legal one-knob deviation from the defaults:
        ``[(knob_name, value, full_config), ...]`` — the hand-tuning moves an
        expert would try first, and the search's seed candidates."""
        base = self.defaults()
        out: List[Tuple[str, Any, Dict[str, Any]]] = []
        for name, knob in self.knobs.items():
            for value in knob.values:
                if value == knob.default:
                    continue
                cfg = dict(base)
                cfg[name] = value
                if self.is_legal(cfg, context):
                    out.append((name, value, cfg))
        return out


def shipped_space() -> KnobSpace:
    """The canonical space over every default-OFF perf knob the repo ships.

    Layer strings name the owning module; ``values`` are the settings worth
    trying (bucket sizes follow the powers-of-4 ladder around
    ``DEFAULT_BUCKET_BYTES``; remat policies are the registered names)."""
    MiB = 1 << 20
    return KnobSpace([
        Knob("opt_level", ("O5", "O6"), "O5", layer="amp.frontend",
             doc="bf16 masters (O5) vs the quantized fp8-style GEMM tier"),
        Knob("remat_policy",
             ("none", "full", "dots_saveable", "save_boundaries"),
             "none", layer="remat.policies",
             doc="activation rematerialization over the block scan"),
        Knob("bucket_bytes", (None, 1 * MiB, 4 * MiB, 16 * MiB, 64 * MiB),
             None, layer="parallel.bucketing",
             doc="gradient-reduction bucket size (None = monolithic)"),
        Knob("bucket_bytes_dcn", (None, 4 * MiB, 32 * MiB), None,
             layer="parallel.bucketing",
             requires=(("hierarchical", True),),
             doc="per-tier DCN bucket size for the two-level reduce"),
        Knob("compress", (False, True), False,
             layer="parallel.compression",
             doc="bf16 wire compression on the gradient collectives"),
        Knob("overlap_backward", (False, True), False,
             layer="parallel.overlap",
             doc="backward-time bucket reduction via custom_vjp hooks"),
        Knob("optimizer_in_backward", (False, True), False,
             layer="parallel.overlap",
             doc="fold the optimizer step into the backward per chunk"),
        Knob("overlap_p2p", (False, True), False,
             layer="transformer.pipeline_parallel",
             doc="double-buffered pipeline send/recv overlap"),
        Knob("collective_matmul", (False, True), False,
             layer="transformer.tensor_parallel.collective",
             requires_context=("sequence_parallel",),
             doc="ppermute-ring matmul hiding the SP all-gather"),
        Knob("prefetch", (0, 1, 2, 4), 1, layer="optimizers.zero3",
             doc="ZeRO-3 bucketed-gather prefetch depth"),
        Knob("hierarchical", (False, True), False,
             layer="parallel.bucketing",
             requires_context=("two_level",),
             doc="two-level (intra-slice + DCN) collectives"),
    ])
