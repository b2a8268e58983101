"""Trace spans — counterpart of ``beforeholiday_tpu/monitor/spans.py``
(``span`` and ``annotate``).

A span is a ``torch.profiler.record_function`` range (it shows in a
``torch.profiler`` trace, with the device kernels it launched under it)
plus an NVTX range on a CUDA build (it shows in Nsight). Both cost a few
microseconds of host time and no device time, and neither reads a device
value, so the DDP reducer carries them unconditionally, as the JAX package
carries its named scopes. ``Timers`` and ``trace`` are not ported yet.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["annotate", "nvtx_range", "span"]


@contextlib.contextmanager
def span(name: str, enabled: bool = True):
    """Named trace span: a profiler range and, where CUDA is built in, an
    NVTX range. ``enabled=False`` makes it a no-op (the reference's ``prof``
    flag)."""
    if not enabled:
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# the JAX package's older name for the same thing
nvtx_range = span


def annotate(name: str):
    """Decorator: run the function inside :func:`span` ``(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
