"""Dispatch policy and padding helpers shared by the kernel-backed ops.

Counterpart of ``beforeholiday_tpu/ops/_pallas_util.py``. The policy is
simpler than the TPU one because PyTorch has no GSPMD partitioner to keep
happy: the device a tensor lives on decides.

* a CUDA tensor runs the hand-written Hopper kernel (``"kernel"``);
* a CPU tensor runs the plain PyTorch version (``"torch"``).

An explicit ``impl=`` is always honored, and an impossible one raises. There
is deliberately no probe-and-downgrade (``guard/dispatch.py:checked_impl`` is
not ported): on a CUDA tensor a wrapper launches its kernel or raises. Each
choice is counted per (op, device type, dtype), the counterpart of
``checked_impl``'s hits (``monitor.counters``); nothing is ever degraded.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

IMPLS = ("kernel", "torch")


_COUNTS_LOCK = threading.Lock()
# (op, device type, dtype) -> {"kernel": n, "torch": n}
_COUNTS: Dict[Tuple[str, str, str], Dict[str, int]] = {}


def resolve_impl(impl: Optional[str], x: torch.Tensor, op: str) -> str:
    """``"kernel"`` for a CUDA tensor and ``"torch"`` for a CPU one when
    ``impl`` is None; an explicit ``impl`` is validated and honored. The
    choice is counted under ``op``."""
    if impl is None:
        impl = "kernel" if x.is_cuda else "torch"
    elif impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    elif impl == "kernel" and not x.is_cuda:
        raise ValueError(
            f"impl='kernel' needs CUDA tensors, got a tensor on {x.device}"
        )
    key = (op, x.device.type, str(x.dtype).replace("torch.", ""))
    with _COUNTS_LOCK:
        row = _COUNTS.get(key)
        if row is None:
            row = _COUNTS[key] = {"kernel": 0, "torch": 0}
        row[impl] += 1
    return impl


def dispatch_counts() -> Dict[Tuple[str, str, str], Dict[str, int]]:
    """Snapshot of the choices: ``{(op, device type, dtype): {"kernel": n,
    "torch": n}}``."""
    with _COUNTS_LOCK:
        return {k: dict(v) for k, v in _COUNTS.items()}


def reset_dispatch_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def call_op(op, fn, *args):
    """Run a kernel that is registered as the custom op ``op`` with the
    implementation ``fn``: through ``op`` where autograd records the call
    or a dispatch mode must see it (a selective checkpoint, a FLOP counter,
    the memory ledger's CPU reading), else ``fn`` itself, which skips the
    op's host cost on the no-grad paths, serving's decode among them
    (measured with ``chip_ab.py --host``, PERF.md §6). Both run the same
    code."""
    if is_in_torch_dispatch_mode() or (torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args)):
        return op(*args)
    return fn(*args)


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


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``: the persistent kernels size
    their grids from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def pad_rows(x: torch.Tensor, block_rows: int) -> Tuple[torch.Tensor, int]:
    """Pad the leading dim to a multiple of ``block_rows`` (any rank).
    Returns ``(padded, rows)``."""
    rows = x.shape[0]
    padded = -(-rows // block_rows) * block_rows
    if padded != rows:
        # F.pad lists pads from the LAST dim backwards
        x = F.pad(x, (0, 0) * (x.ndim - 1) + (0, padded - rows))
    return x, rows
