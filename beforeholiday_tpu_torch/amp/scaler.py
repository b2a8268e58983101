"""Dynamic loss scaling — counterpart of ``beforeholiday_tpu/amp/scaler.py``.

The whole scaler lives in device state: ``scale`` and the counters are 0-d
device tensors, overflow detection rides the unscale kernel's flag (K5),
and the update is pure ``torch.where`` arithmetic. Nothing in
:meth:`LossScaler.scale_loss`, :meth:`~LossScaler.unscale` or
:meth:`~LossScaler.update` reads a value back to the host, so a training
step never waits on the card. :meth:`~LossScaler.state_dict` and
:meth:`~LossScaler.load_state_dict` do read back; they sit outside the step.

O6 (``quantized=True``) carries the fp8 delayed-scaling amax history
(``ops.quantized``) in the same state dict, one rolling row per
``HISTORY_ROLES`` entry, so the quantization scales ride the same skip,
rollback and checkpoint machinery as the loss scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from beforeholiday_tpu_torch.ops import multi_tensor as mt
from beforeholiday_tpu_torch.ops import quantized as q8
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static scaler config; all dynamics live in the state dict. Defaults
    match the reference: dynamic scaling starts at 2**16, doubles every 2000
    clean steps, halves on overflow."""

    loss_scale: Any = "dynamic"  # "dynamic" | float
    init_scale: float = 2.0**16
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: Optional[float] = None
    max_loss_scale: float = 2.0**24
    # O6: the fp8 amax history rides in the state dict
    quantized: bool = False
    amax_history_len: int = 16
    amax_margin: float = 2.0

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """Fresh state on ``device`` (``cuda`` unless the caller asks for
        another one; raises without a card)."""
        device = resolve_device(device)
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        state = {
            "scale": torch.full((), scale, dtype=torch.float32, device=device),
            "unskipped": torch.zeros((), dtype=torch.int32, device=device),
            "consecutive_overflows": torch.zeros((), dtype=torch.int32,
                                                 device=device),
        }
        if self.quantized:
            state["amax_history"] = q8.init_amax_history(self.amax_history_len,
                                                         device=device)
        return state

    def at_min_scale(self, state) -> torch.Tensor:
        """True (a device bool) when the scale cannot shrink further: always
        for a static scale, never for a dynamic one without a floor."""
        scale = state["scale"]
        if not self.dynamic:
            return torch.ones((), dtype=torch.bool, device=scale.device)
        if self.min_loss_scale is None:
            return torch.zeros((), dtype=torch.bool, device=scale.device)
        return scale <= self.min_loss_scale

    def scale_loss(self, loss: torch.Tensor, state) -> torch.Tensor:
        """``loss.float() * scale``."""
        return loss.float() * state["scale"]

    def unscale(self, grads, state, *, impl=None) -> Tuple[Any, torch.Tensor]:
        """Unscale a grad tree (or the arenas of a :class:`PackedParams`) by
        ``1/scale``; returns ``(fp32 grads, found_inf)``. One K5 launch per
        gradient dtype; ``found_inf`` ORs their flags."""
        packed = isinstance(grads, PackedParams)
        if packed:
            leaves = list(grads.arenas)
        else:
            leaves, treedef = tree_flatten(grads)
        inv = 1.0 / state["scale"]
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        out = list(leaves)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, g in enumerate(leaves):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            scaled, flag = mt.multi_tensor_scale(
                [leaves[i] for i in idx], inv, out_dtype=torch.float32,
                impl=impl)
            for i, s in zip(idx, scaled):
                out[i] = s
            found = found | flag
        if packed:
            return grads.replace_arenas(out), found
        return tree_unflatten(treedef, out), found

    def quantized_scales(self, state):
        """(scale_w, scale_g) for this step's ``ops.quantized
        .quantized_scope``, from the state's amax history; (None, None) for
        a state without one."""
        if not (isinstance(state, dict) and "amax_history" in state):
            return None, None
        return q8.scales_from_history(state["amax_history"],
                                      margin=self.amax_margin)

    def update(self, state, found_inf, *, amax=None) -> Dict[str, torch.Tensor]:
        """Post-step scale update: overflow halves the scale and resets the
        clean-step counter; ``scale_window`` clean steps double it.
        ``consecutive_overflows`` counts back-to-back skipped steps for both
        dynamic and static scales. ``amax``, this step's (weight, grad)
        observations, rolls into the amax history of a state that has one;
        a non-finite observation is dropped, so an overflow step only trips
        the skip."""
        skip = torch.as_tensor(found_inf) != 0
        consec = torch.where(
            skip, state["consecutive_overflows"] + 1, 0).to(torch.int32)
        extra = {}
        if amax is not None and "amax_history" in state:
            extra["amax_history"] = q8.update_amax_history(
                state["amax_history"], amax[0], amax[1])
        if not self.dynamic:
            return {**state, "consecutive_overflows": consec, **extra}
        scale, unskipped = state["scale"], state["unskipped"]
        shrunk = scale / self.scale_factor
        if self.min_loss_scale is not None:
            shrunk = torch.clamp(shrunk, min=self.min_loss_scale)
        unskipped_next = torch.where(skip, 0, unskipped + 1).to(torch.int32)
        grow = unskipped_next >= self.scale_window
        grown = torch.clamp(scale * self.scale_factor, max=self.max_loss_scale)
        return {
            **state,
            "scale": torch.where(skip, shrunk, torch.where(grow, grown, scale)),
            "unskipped": torch.where(grow, 0, unskipped_next).to(torch.int32),
            "consecutive_overflows": consec,
            **extra,
        }

    # --- checkpointing (outside the step: these read values back) --------

    def state_dict(self, state) -> Dict[str, Any]:
        out = {
            "loss_scale": float(state["scale"]),
            "unskipped": int(state["unskipped"]),
            "consecutive_overflows": int(state.get("consecutive_overflows", 0)),
        }
        if "amax_history" in state:
            # nested lists, ready for JSON; a pre-O6 loader ignores the key
            out["amax_history"] = state["amax_history"].float().cpu().tolist()
        return out

    def load_state_dict(self, state_dict, device=None) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`state_dict`. Pre-O6 and O6 dicts load either
        way: an O6 dict's history is kept, and a quantized scaler given a
        dict without one starts a fresh history (the delayed scales warm up
        again from their just-in-time fallbacks)."""
        device = resolve_device(device)
        out = {
            "scale": torch.tensor(float(state_dict["loss_scale"]),
                                  dtype=torch.float32, device=device),
            "unskipped": torch.tensor(int(state_dict["unskipped"]),
                                      dtype=torch.int32, device=device),
            "consecutive_overflows": torch.tensor(
                int(state_dict.get("consecutive_overflows", 0)),
                dtype=torch.int32, device=device),
        }
        if "amax_history" in state_dict:
            out["amax_history"] = torch.tensor(state_dict["amax_history"],
                                               dtype=torch.float32, device=device)
        elif self.quantized:
            out["amax_history"] = q8.init_amax_history(self.amax_history_len,
                                                       device=device)
        return out
