"""Device-side training metrics — counterpart of
``beforeholiday_tpu/monitor/metrics.py``.

A metric is observable without a host sync only if it stays on the device,
threaded through the step like the scaler's scale or the guard's health.
So ``TrainMonitor`` keeps the JAX package's pattern (a config class and a
dict of 0-d device tensors, the ``Metrics``):

* ``init()``            → the metrics dict on the device
* ``update(...)``       → this step's observations folded in, device ops only
* ``aggregate(...)``    → cross-rank sum / max / min over a
                          ``torch.distributed`` group (JAX: ``psum`` /
                          ``pmax`` / ``pmin``), one collective per reduction
* ``pack(...)``         → ONE flat fp32 vector, so the host drains every
                          metric with a single device-to-host copy

Nothing here reads a value back to the host; the sanctioned readbacks are
``monitor/export.py``'s ``MetricsLogger.drain`` and the ``state_dict``
family below.

:func:`global_norm` of a packed model (``PackedParams``) or of an arena
runs K9's sum of squares (``ops.multi_tensor.l2norm_sq``) on a CUDA arena
and its plain version on the CPU; a tree of leaves stays plain PyTorch, as
in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import is_arena, tree_flatten

Metrics = Dict[str, torch.Tensor]

_F32 = torch.float32
_I32 = torch.int32


def _arenas(tree: Any) -> Optional[Tuple[torch.Tensor, ...]]:
    """The flat arenas of a packed model or of a list of arenas, else None."""
    if hasattr(tree, "arenas") and hasattr(tree, "layout"):
        return tuple(tree.arenas)
    if isinstance(tree, torch.Tensor) and is_arena(tree):
        return (tree,)
    if isinstance(tree, (list, tuple)) and tree and all(
            isinstance(t, torch.Tensor) and is_arena(t) for t in tree):
        return tuple(tree)
    return None


def global_norm(tree: Any) -> torch.Tensor:
    """fp32 L2 norm over every leaf of ``tree`` (the multi_tensor_l2norm
    quantity): K9 over each arena of a packed model (its plain version on
    the CPU), plain PyTorch over a tree's leaves. A 0-d device tensor."""
    from beforeholiday_tpu_torch.ops.multi_tensor import l2norm_sq

    arenas = _arenas(tree)
    if arenas is not None:
        sq = sum(l2norm_sq(a)[0] for a in arenas)
        return torch.sqrt(sq)
    leaves = [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    if not leaves:
        return torch.zeros((), dtype=_F32)
    sq = sum(torch.sum(torch.square(g.to(_F32))) for g in leaves)
    return torch.sqrt(sq)


def _difference(new: Any, old: Any) -> Any:
    """``new - old`` in fp32, arena by arena or leaf by leaf."""
    a, b = _arenas(new), _arenas(old)
    if a is not None and b is not None:
        return [x.to(_F32) - y.to(_F32) for x, y in zip(a, b)]
    return [x.to(_F32) - y.to(_F32)
            for x, y in zip(tree_flatten(new)[0], tree_flatten(old)[0])]


class TrainMonitor:
    """Config + pure functions over the ``Metrics`` dict.

    The metric set is fixed at construction (``_SPEC``): each key carries its
    dtype and its cross-rank reduction (``mean`` → sum / world, ``max``,
    ``min``). The counters folded in from ``StepGuard.health`` use max:
    ranks run the guard in lockstep, so max is the consensus value.
    """

    # (key, dtype, cross-rank reduction) — ORDER IS THE PACK ORDER and is
    # part of the checkpoint/export contract, the JAX package's; append only
    _SPEC: Tuple[Tuple[str, Any, str], ...] = (
        ("steps", _I32, "max"),
        ("loss", _F32, "mean"),
        ("loss_ema", _F32, "mean"),
        ("grad_norm", _F32, "mean"),
        ("grad_norm_ema", _F32, "mean"),
        ("grad_norm_max", _F32, "max"),
        ("param_norm", _F32, "mean"),
        ("update_norm", _F32, "mean"),
        ("update_ratio", _F32, "mean"),
        ("loss_scale", _F32, "min"),
        ("skipped_total", _I32, "max"),
        ("consecutive_overflows", _I32, "max"),
        ("rollbacks_total", _I32, "max"),
        ("last_skip_reason", _I32, "max"),
        ("bn_shift_dominated", _I32, "max"),
        ("moe_aux_loss", _F32, "mean"),
        ("moe_z_loss", _F32, "mean"),
        ("moe_drop_fraction", _F32, "mean"),
    )
    _HEALTH_KEYS = ("skipped_total", "consecutive_overflows", "rollbacks_total",
                    "last_skip_reason", "bn_shift_dominated")
    _MOE_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")

    def __init__(self, *, ema_decay: float = 0.99):
        assert 0.0 <= ema_decay < 1.0, "ema_decay must be in [0, 1)"
        self.ema_decay = float(ema_decay)

    @property
    def keys(self) -> Tuple[str, ...]:
        return tuple(k for k, _, _ in self._SPEC)

    def init(self, device=None) -> Metrics:
        """Zeros on ``device`` (the card unless the caller asks for the
        CPU)."""
        device = resolve_device(device)
        return {k: torch.zeros((), dtype=dt, device=device)
                for k, dt, _ in self._SPEC}

    def update(
        self,
        metrics: Metrics,
        *,
        loss: Optional[torch.Tensor] = None,
        grads: Any = None,
        params: Any = None,
        new_params: Any = None,
        scaler_state: Optional[Dict[str, torch.Tensor]] = None,
        health: Optional[Dict[str, torch.Tensor]] = None,
        moe: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Metrics:
        """Fold one step's observations into a new metrics dict, on the
        device. Every argument is optional: pass what the step has, the
        rest carries forward. ``new_params`` (post-update) with ``params``
        gives the update norm and the update/param-norm ratio (copy
        ``params`` first where the optimizer updates them in place)."""
        steps = metrics["steps"]
        # JAX's fp32 decay and its fp32 complement, as Python scalars (an
        # fp32 tensor takes them in fp32): no host-to-device copy
        decay = float(np.float32(self.ema_decay))
        rest = float(np.float32(1.0) - np.float32(self.ema_decay))
        first = steps == 0

        def ema(prev, v):
            # seed the EMA with the first observation instead of decaying
            # from zero
            return torch.where(first, v, decay * prev + rest * v)

        def f32(v):
            return torch.as_tensor(v, dtype=_F32, device=steps.device)

        m = dict(metrics)
        if loss is not None:
            v = f32(loss)
            m["loss"] = v
            m["loss_ema"] = ema(metrics["loss_ema"], v)
        if grads is not None:
            g = global_norm(grads)
            m["grad_norm"] = g
            m["grad_norm_ema"] = ema(metrics["grad_norm_ema"], g)
            m["grad_norm_max"] = torch.maximum(metrics["grad_norm_max"], g)
        if params is not None:
            p = global_norm(params)
            m["param_norm"] = p
            if new_params is not None:
                u = global_norm(_difference(new_params, params))
                m["update_norm"] = u
                m["update_ratio"] = u / torch.clamp(p, min=1e-12)
        if scaler_state is not None:
            m["loss_scale"] = f32(scaler_state["scale"])
        if moe is not None:
            for k in self._MOE_KEYS:
                if k in moe:
                    m[k] = f32(moe[k])
        if health is not None:
            for k in self._HEALTH_KEYS:
                if k in health:
                    m[k] = torch.as_tensor(health[k], device=steps.device).to(_I32)
        m["steps"] = steps + 1
        return m

    def aggregate(self, metrics: Metrics, axis_name: str) -> Metrics:
        """Cross-rank reduction per each key's declared semantics over the
        ``torch.distributed`` group of ``axis_name`` (a ``parallel_state``
        axis): three all-reduces, one per reduction kind."""
        from beforeholiday_tpu_torch.parallel.parallel_state import get_group

        group = get_group(axis_name)
        world = dist.get_world_size(group)
        out = dict(metrics)
        ops = {"mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
        for red, op in ops.items():
            keys = [(k, dt) for k, dt, r in self._SPEC if r == red]
            # the mean keys are fp32; max and min mix int32 and fp32 keys,
            # which ride in one fp64 vector (exact for both)
            wide = _F32 if red == "mean" else torch.float64
            vec = torch.stack([metrics[k].to(wide) for k, _ in keys])
            dist.all_reduce(vec, op=op, group=group)
            for i, (k, dt) in enumerate(keys):
                v = vec[i] / world if red == "mean" else vec[i]
                out[k] = v.to(dt)
        return out

    def pack(self, metrics: Metrics) -> torch.Tensor:
        """Stack every metric into ONE fp32 vector (pack order = ``_SPEC``
        order), for ``MetricsLogger.log``: one copy drains it."""
        return torch.stack([metrics[k].to(_F32) for k in self.keys])

    def unpack_host(self, vec) -> Dict[str, float]:
        """Host-side inverse of ``pack`` over an ALREADY-FETCHED vector (a
        numpy array or a list). Integer metrics come back as Python ints."""
        vals = np.asarray(vec).tolist()
        assert len(vals) == len(self._SPEC), (
            f"packed vector has {len(vals)} entries, spec has {len(self._SPEC)}"
        )
        out: Dict[str, float] = {}
        for (k, dt, _), v in zip(self._SPEC, vals):
            out[k] = int(v) if dt == _I32 else float(v)
        return out

    def state_dict(self, metrics: Metrics) -> Dict[str, Any]:
        """Host-side snapshot (a sanctioned sync, as the scaler's and the
        guard's ``state_dict``): two copies, the integers exact."""
        ints = [k for k, dt, _ in self._SPEC if dt == _I32]
        floats = [k for k, dt, _ in self._SPEC if dt == _F32]
        iv = torch.stack([metrics[k].to(torch.int64) for k in ints]).tolist()
        fv = torch.stack([metrics[k].to(_F32) for k in floats]).tolist()
        got = {**dict(zip(ints, (int(v) for v in iv))),
               **dict(zip(floats, (float(v) for v in fv)))}
        return {k: got[k] for k in self.keys}

    def load_state_dict(self, state: Dict[str, Any], device=None) -> Metrics:
        """Rebuild the device dict from a snapshot. Unknown keys are ignored
        and missing keys default to zero, so checkpoints survive spec growth
        in either direction."""
        m = self.init(device)
        for k, dt, _ in self._SPEC:
            if k in state:
                m[k] = torch.tensor(state[k], dtype=dt, device=m[k].device)
        return m
