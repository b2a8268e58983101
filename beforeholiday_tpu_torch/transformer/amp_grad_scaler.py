"""Model-parallel grad scaler — counterpart of
``beforeholiday_tpu/transformer/amp_grad_scaler.py`` (ref:
apex/transformer/amp/grad_scaler.py:21-119).

An overflow anywhere in the model must skip the step on every rank, or one
rank skips while another applies it and the shards part for good: the
found-inf flag takes its maximum over the tensor and pipeline groups
(ref: grad_scaler.py:51), one all-reduce a group (site
``amp.found_inf``), on the device, with no host sync.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from beforeholiday_tpu_torch.amp.scaler import LossScaler
from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel.parallel_state import PIPE_AXIS, TENSOR_AXIS

__all__ = ["GradScaler", "reduce_found_inf"]


def reduce_found_inf(found_inf, axis_names: Sequence[str] = (TENSOR_AXIS, PIPE_AXIS)
                     ) -> torch.Tensor:
    """OR the overflow flag across the model-parallel groups: a device bool
    (ref: grad_scaler.py:51 ``all_reduce(found_inf, MAX,
    model_parallel_group)``)."""
    flag = torch.as_tensor(found_inf).float()
    for axis in axis_names:
        flag = comms.pmax(flag, axis, site="amp.found_inf")
    return flag != 0


class GradScaler(LossScaler):
    """LossScaler whose ``unscale`` returns the model-parallel-global flag,
    so every rank's update and skip see the same overflow."""

    def __init__(self, *args, axis_names: Sequence[str] = (TENSOR_AXIS, PIPE_AXIS),
                 **kw):
        super().__init__(*args, **kw)
        object.__setattr__(self, "axis_names", tuple(axis_names))

    def unscale(self, grads, state, *, impl=None) -> Tuple[object, torch.Tensor]:
        grads, found = super().unscale(grads, state, impl=impl)
        return grads, reduce_found_inf(found, self.axis_names)
