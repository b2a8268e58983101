"""Dispatch policy and padding helpers shared by the kernel-backed ops.

Counterpart of ``beforeholiday_tpu/ops/_pallas_util.py``. The policy is
simpler than the TPU one because PyTorch has no GSPMD partitioner to keep
happy: the device a tensor lives on decides.

* a CUDA tensor runs the hand-written Hopper kernel (``"kernel"``);
* a CPU tensor runs the plain PyTorch version (``"torch"``).

An explicit ``impl=`` is always honored, and an impossible one raises. There
is deliberately no probe-and-downgrade (``guard/dispatch.py:checked_impl`` is
not ported): on a CUDA tensor a wrapper launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMPLS = ("kernel", "torch")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``"kernel"`` for a CUDA tensor and ``"torch"`` for a CPU one when
    ``impl`` is None; an explicit ``impl`` is validated and honored."""
    if impl is None:
        return "kernel" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and not x.is_cuda:
        raise ValueError(
            f"impl='kernel' needs CUDA tensors, got a tensor on {x.device}"
        )
    return impl


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another one. With no card and no explicit device it raises rather than
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def pad_rows(x: torch.Tensor, block_rows: int) -> Tuple[torch.Tensor, int]:
    """Pad the leading dim to a multiple of ``block_rows`` (any rank).
    Returns ``(padded, rows)``."""
    rows = x.shape[0]
    padded = -(-rows // block_rows) * block_rows
    if padded != rows:
        # F.pad lists pads from the LAST dim backwards
        x = F.pad(x, (0, 0) * (x.ndim - 1) + (0, padded - rows))
    return x, rows
