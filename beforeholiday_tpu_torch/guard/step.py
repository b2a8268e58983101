"""StepGuard — counterpart of ``beforeholiday_tpu/guard/step.py``: the
device-side robustness state machine around a training step.

The guard extends the loss scaler's skip step: non-finite sentinels on the
loss and the UPDATED params, the combined skip decision threaded into the
fused optimizers as their ``found_inf``, and a last-good snapshot of the
params restored after K consecutive overflows at the scaler's floor. It is
``torch.where`` arithmetic on device state: no ``.item()``, no host branch
on a device value, so a guarded step never waits on the card.

One difference from the JAX guard, forced by the port's optimizers: they
update the master, moment and model arenas IN PLACE
(``optimizers/fused.py``), where JAX's ``_tree_select`` gets the pre-step
values for free. So ``check_params=True`` copies the params and the
optimizer state before the step, and a reverted step selects those copies
back into the updated tensors; ``rollback_after`` keeps a snapshot of the
params, refreshed on clean steps by a select into the same tensors. Both
copy nothing when unarmed.

Skip reasons are small int codes::

    0 none | 1 grad overflow | 2 loss non-finite | 3 param non-finite | 4 rollback

The ``health`` dict (``consecutive_overflows``, ``skipped_total``,
``last_skip_reason``, ``rollbacks_total``, device int32) rides in the guard
state and is serialized by ``amp.AmpModel.state_dict`` as ``health{i}``.
``apply_sharded_update`` (the ZeRO-3 triplet) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from beforeholiday_tpu_torch.ops.arena import (
    PackedParams,
    tree_flatten,
    tree_map,
)

SKIP_NONE = 0
SKIP_GRAD_OVERFLOW = 1
SKIP_LOSS_NONFINITE = 2
SKIP_PARAM_NONFINITE = 3
SKIP_ROLLBACK = 4

SKIP_REASON_NAMES = {
    SKIP_NONE: "none",
    SKIP_GRAD_OVERFLOW: "grad_overflow",
    SKIP_LOSS_NONFINITE: "loss_nonfinite",
    SKIP_PARAM_NONFINITE: "param_nonfinite",
    SKIP_ROLLBACK: "rollback",
}

_HEALTH_KEYS = (
    "consecutive_overflows",
    "skipped_total",
    "last_skip_reason",
    "rollbacks_total",
)
# liveness keys an elastic metrics row may carry beside the health
_LIVENESS_KEYS = ("world", "mismatch")


def health_summary(health: Dict[str, Any]) -> Dict[str, Any]:
    """Readable rendering of an already-fetched health row (host numbers):
    the health and liveness keys present, and the skip reason's name."""
    out = {k: health[k] for k in (*_HEALTH_KEYS, *_LIVENESS_KEYS) if k in health}
    reason = health.get("last_skip_reason")
    if reason is not None:
        out["last_skip_reason_name"] = SKIP_REASON_NAMES.get(
            int(reason), f"unknown({reason})")
    return out


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params or state tree; a PackedParams' arenas."""
    if isinstance(tree, PackedParams):
        return list(tree.arenas)
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _tree_nonfinite(tree) -> torch.Tensor:
    """A device bool: any floating tensor of ``tree`` holds a non-finite
    value."""
    flags = [torch.isfinite(t).logical_not().any() for t in _leaves(tree)
             if t.is_floating_point()]
    if not flags:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack(flags).any()


def _select_into(pred, on_true: List[torch.Tensor], dst: List[torch.Tensor]):
    """``dst[i] = where(pred, on_true[i], dst[i])`` in place: a skipped
    step's values come back bit-identical to ``on_true``."""
    for t, d in zip(on_true, dst):
        torch.where(pred, t, d, out=d)


def _copy(tree):
    if isinstance(tree, PackedParams):
        return tree.replace_arenas([a.clone() for a in tree.arenas])
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class StepGuard:
    """Static guard config; the dynamics live in the guard state dict.

    ``rollback_after=K`` (0 disables) arms the last-good-params snapshot:
    after K consecutive skipped steps while the scaler can shrink no further
    (:meth:`LossScaler.at_min_scale`), the params are restored to the last
    clean step's. ``check_params=True`` screens the UPDATED params each step
    and reverts the params AND the optimizer state when they come back
    non-finite."""

    def __init__(self, scaler=None, *, rollback_after: int = 0,
                 check_params: bool = False):
        if rollback_after < 0:
            raise ValueError(f"rollback_after must be >= 0, got {rollback_after}")
        if scaler is None:
            from beforeholiday_tpu_torch.amp.scaler import LossScaler

            scaler = LossScaler()
        self.scaler = scaler
        self.rollback_after = int(rollback_after)
        self.check_params = bool(check_params)

    # --- state ------------------------------------------------------------

    def _health(self, device, values=None):
        values = values or {}
        return {k: torch.tensor(int(values.get(k, 0)), dtype=torch.int32,
                                device=device) for k in _HEALTH_KEYS}

    def init(self, params: Any, device=None) -> Dict[str, Any]:
        """Fresh guard state: the scaler's, zero health and, with
        ``rollback_after``, a copy of ``params`` as the snapshot. ``device``
        defaults to the params'."""
        if device is None:
            device = _leaves(params)[0].device
        state = {"scaler": self.scaler.init(device=device),
                 "health": self._health(device)}
        if self.rollback_after:
            state["snapshot"] = _copy(params)
        return state

    # --- sentinels --------------------------------------------------------

    def value_and_grad(self, loss_fn: Callable, *, has_aux: bool = False,
                       impl=None, reduce_grads: Optional[Callable] = None
                       ) -> Callable:
        """Like ``amp.scaled_value_and_grad``, but the scaler state does not
        advance here: the final skip decision is known only in
        :meth:`apply_update`, which owns the scale update.

        Returns ``f(params, gstate, *args) -> (loss, [aux,] grads,
        verdict)`` with fp32 unscaled grads and a verdict of device bools
        (``grad_overflow``, ``loss_nonfinite``). ``reduce_grads`` runs on the
        still-scaled grads before the unscale, so every rank sees the
        reduced grads and takes the same skip decision. With a quantized
        scaler (O6) the step's fp8 scales come from the history and the
        verdict carries the step's amax observations (``amax``)."""
        from beforeholiday_tpu_torch.amp.frontend import scaled_grads

        def wrapped(params, gstate, *args, **kw):
            sstate = gstate["scaler"]
            loss, aux, grads, amax = scaled_grads(
                loss_fn, self.scaler, params, sstate, args, kw,
                has_aux=has_aux, reduce_grads=reduce_grads)
            grads, grad_inf = self.scaler.unscale(grads, sstate, impl=impl)
            verdict = {"grad_overflow": grad_inf != 0,
                       "loss_nonfinite": _tree_nonfinite(loss)}
            if amax is not None:
                # O6: the step's amax observations ride the verdict into
                # apply_update, which owns the scale and history update
                verdict["amax"] = amax
            if has_aux:
                return loss, aux, grads, verdict
            return loss, grads, verdict

        return wrapped

    def check_grads(self, loss, grads) -> Dict[str, torch.Tensor]:
        """A verdict from externally produced (loss, grads)."""
        return {"grad_overflow": _tree_nonfinite(grads),
                "loss_nonfinite": _tree_nonfinite(loss)}

    # --- the guarded update -------------------------------------------------

    def apply_update(self, opt, params, grads, opt_state, gstate,
                     verdict: Dict[str, torch.Tensor], *, grad_scale=1.0,
                     extra_found_inf=None, **opt_kw):
        """One guarded optimizer step; returns ``(params, opt_state,
        gstate)``. In the JAX guard's order, every step a device select:

        1. the optimizer step with ``found_inf = grad_overflow |
           loss_nonfinite | extra_found_inf`` (the fused kernels' skip);
        2. ``check_params``: non-finite updated params revert the params
           AND the optimizer state to their pre-step copies;
        3. the scale update with the total skip;
        4. the health counters (``consecutive_overflows`` is the scaler's);
        5. rollback: after ``rollback_after`` consecutive skips with the
           scaler at its floor, params := snapshot; on clean steps
           snapshot := the new params.
        """
        pre_inf = verdict["grad_overflow"] | verdict["loss_nonfinite"]
        if extra_found_inf is not None:
            pre_inf = pre_inf | (torch.as_tensor(extra_found_inf) != 0)
        before = None
        if self.check_params:
            before = ([t.clone() for t in _leaves(params)],
                      [t.clone() for t in _leaves(opt_state)])
        new_params, new_opt_state = opt.step(
            params, grads, opt_state, found_inf=pre_inf, grad_scale=grad_scale,
            **opt_kw)

        param_bad = torch.zeros_like(pre_inf)
        if self.check_params:
            param_bad = _tree_nonfinite(new_params) & ~pre_inf
            _select_into(param_bad, before[0], _leaves(new_params))
            _select_into(param_bad, before[1], _leaves(new_opt_state))
        skip = pre_inf | param_bad

        sstate = self.scaler.update(gstate["scaler"], skip,
                                    amax=verdict.get("amax"))
        consec = sstate["consecutive_overflows"]
        reason_now = torch.where(
            verdict["loss_nonfinite"], SKIP_LOSS_NONFINITE,
            torch.where(verdict["grad_overflow"], SKIP_GRAD_OVERFLOW,
                        SKIP_PARAM_NONFINITE))
        health = dict(gstate["health"])
        health["skipped_total"] = health["skipped_total"] + skip.to(torch.int32)
        health["last_skip_reason"] = torch.where(
            skip, reason_now, health["last_skip_reason"]).to(torch.int32)

        new_state = {"scaler": sstate, "health": health}
        if self.rollback_after:
            snapshot = gstate["snapshot"]
            trigger = (skip & (consec >= self.rollback_after)
                       & self.scaler.at_min_scale(sstate))
            _select_into(trigger, _leaves(snapshot), _leaves(new_params))
            # the snapshot holds on a skipped step, else takes the new params
            _select_into(~skip, _leaves(new_params), _leaves(snapshot))
            new_state["snapshot"] = snapshot
            consec = torch.where(trigger, 0, consec).to(torch.int32)
            new_state["scaler"] = {**sstate, "consecutive_overflows": consec}
            health["rollbacks_total"] = (health["rollbacks_total"]
                                         + trigger.to(torch.int32))
            health["last_skip_reason"] = torch.where(
                trigger, SKIP_ROLLBACK, health["last_skip_reason"]).to(torch.int32)
        health["consecutive_overflows"] = consec.to(torch.int32)
        return new_params, new_opt_state, new_state

    def apply_sharded_update(self, *args, **kwargs):
        """The ZeRO-3 shard triplet's guarded update: not ported yet."""
        raise NotImplementedError(
            "StepGuard.apply_sharded_update needs ZeRO-3 (optimizers/zero3.py), "
            "which is not ported yet")

    # --- checkpointing (host-side: these read values back) -----------------

    def state_dict(self, gstate) -> Dict[str, Any]:
        out = self.scaler.state_dict(gstate["scaler"])
        out["health"] = {k: int(gstate["health"][k]) for k in _HEALTH_KEYS}
        return out

    def load_state_dict(self, state_dict, params: Any = None, device=None
                        ) -> Dict[str, Any]:
        """Inverse of :meth:`state_dict`; a dict without ``health`` loads
        as zero health. ``params`` re-seeds the rollback snapshot (required
        when ``rollback_after`` is armed)."""
        scaler_sd = {k: v for k, v in state_dict.items() if k != "health"}
        sstate = self.scaler.load_state_dict(scaler_sd, device=device)
        state = {"scaler": sstate,
                 "health": self._health(sstate["scale"].device,
                                        state_dict.get("health", {}))}
        if self.rollback_after:
            if params is None:
                raise ValueError(
                    "rollback_after is armed: load_state_dict needs params to "
                    "re-seed the last-good snapshot")
            state["snapshot"] = _copy(params)
        return state
