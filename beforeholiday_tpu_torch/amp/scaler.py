"""Dynamic loss scaling — counterpart of ``beforeholiday_tpu/amp/scaler.py``.

The whole scaler lives in device state: ``scale`` and the counters are 0-d
device tensors, overflow detection rides the unscale kernel's flag (K5),
and the update is pure ``torch.where`` arithmetic. Nothing in
:meth:`LossScaler.scale_loss`, :meth:`~LossScaler.unscale` or
:meth:`~LossScaler.update` reads a value back to the host, so a training
step never waits on the card. :meth:`~LossScaler.state_dict` and
:meth:`~LossScaler.load_state_dict` do read back; they sit outside the step.

The O6 parts of the reference scaler (``quantized`` and its fp8 amax
history) are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from beforeholiday_tpu_torch.ops import multi_tensor as mt
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten, tree_unflatten

_O6 = "the O6 quantized tier (fp8 amax history) is not ported yet"


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
    quantized: bool = False  # O6: raises, not ported

    def __post_init__(self):
        if self.quantized:
            raise NotImplementedError(_O6)

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """Fresh state on ``device`` (``cuda`` unless the caller asks for
        another one; raises without a card)."""
        device = resolve_device(device)
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        return {
            "scale": torch.full((), scale, dtype=torch.float32, device=device),
            "unskipped": torch.zeros((), dtype=torch.int32, device=device),
            "consecutive_overflows": torch.zeros((), dtype=torch.int32,
                                                 device=device),
        }

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

    def update(self, state, found_inf) -> Dict[str, torch.Tensor]:
        """Post-step scale update: overflow halves the scale and resets the
        clean-step counter; ``scale_window`` clean steps double it.
        ``consecutive_overflows`` counts back-to-back skipped steps for both
        dynamic and static scales."""
        skip = torch.as_tensor(found_inf) != 0
        consec = torch.where(
            skip, state["consecutive_overflows"] + 1, 0).to(torch.int32)
        if not self.dynamic:
            return {**state, "consecutive_overflows": consec}
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
        }

    # --- checkpointing (outside the step: these read values back) --------

    def state_dict(self, state) -> Dict[str, Any]:
        return {
            "loss_scale": float(state["scale"]),
            "unskipped": int(state["unskipped"]),
            "consecutive_overflows": int(state.get("consecutive_overflows", 0)),
        }

    def load_state_dict(self, state_dict, device=None) -> Dict[str, torch.Tensor]:
        if "amax_history" in state_dict:
            raise NotImplementedError(_O6)
        device = resolve_device(device)
        return {
            "scale": torch.tensor(float(state_dict["loss_scale"]),
                                  dtype=torch.float32, device=device),
            "unskipped": torch.tensor(int(state_dict["unskipped"]),
                                      dtype=torch.int32, device=device),
            "consecutive_overflows": torch.tensor(
                int(state_dict.get("consecutive_overflows", 0)),
                dtype=torch.int32, device=device),
        }
