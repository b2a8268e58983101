"""Tensor-parallel data broadcast — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/data.py`` (ref:
apex/transformer/tensor_parallel/data.py:25-122).

The reference broadcasts the batch dict from tensor rank 0 so every tensor
peer sees the same data. ``force=False`` validates the keys and dtypes and
returns the batch as given (every rank was fed the same batch);
``force=True`` takes rank 0's values through a masked all-reduce, as the JAX
package does, booked at ``tp.broadcast_data``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS, get_group

__all__ = ["broadcast_data"]


def broadcast_data(
    keys: Sequence[str],
    data: Dict[str, torch.Tensor],
    datatype=None,
    *,
    axis_name: str = TENSOR_AXIS,
    force: bool = False,
) -> Dict[str, torch.Tensor]:
    """The batch as tensor rank 0 sees it (see the module docstring)."""
    out = {}
    for k in keys:
        if k not in data:
            raise KeyError(f"broadcast_data: missing key {k!r}")
        v = data[k]
        if datatype is not None and v.dtype != datatype:
            raise TypeError(f"broadcast_data: {k} has dtype {v.dtype}, "
                            f"expected {datatype}")
        if force:
            is_src = dist.get_rank(get_group(axis_name)) == 0
            v = comms.psum(v if is_src else torch.zeros_like(v), axis_name,
                           site="tp.broadcast_data")
        out[k] = v
    return out
