"""MemoryBuffer and RingMemBuffer — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/memory.py`` (ref:
apex/transformer/tensor_parallel/memory.py:25-146).

One preallocated flat tensor handing out views, as the reference's, to keep
activation-sized temporaries off the allocator. The JAX module re-exports
``remat.donation``'s donation helpers at this path; PyTorch updates in place,
so they have no counterpart here (ROADMAP A13).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from beforeholiday_tpu_torch.ops._dispatch import resolve_device

__all__ = ["MemoryBuffer", "RingMemBuffer"]


class MemoryBuffer:
    """Flat preallocated buffer handing out reshaped views (ref:
    memory.py:25-77). On the card unless ``device`` says otherwise."""

    def __init__(self, numel: int, dtype=torch.float32, device=None):
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros((numel,), dtype=dtype, device=resolve_device(device))

    def zero(self) -> None:
        self.data.zero_()

    def get(self, shape: Tuple[int, ...], start_index: int) -> torch.Tensor:
        """A view of ``[start, start + prod(shape))`` shaped ``shape``."""
        n = math.prod(shape)
        if start_index < 0 or start_index + n > self.numel:
            raise ValueError(
                f"requested {n} elements at offset {start_index} exceeds buffer "
                f"size {self.numel}")
        return self.data[start_index:start_index + n].view(shape)


class RingMemBuffer:
    """Ring of MemoryBuffers (ref: memory.py:80-146 ``RingMemBuffer``)."""

    def __init__(self, num_buffers: int, numel: int, dtype=torch.float32,
                 device=None):
        self.num_buffers = num_buffers
        self.buffers = [MemoryBuffer(numel, dtype, device)
                        for _ in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        self._index = (self._index + 1) % self.num_buffers
        return self.buffers[self._index]
