"""Dtype helpers and per-op precision tags — the part of
``beforeholiday_tpu/ops/_autocast.py`` that the serving path and the O0/O5
training step need.

:func:`cast_floats` is the one-time weight and input cast. :func:`half_function`
and :func:`float_function` tag an op with its amp list (the reference's
FP16_FUNCS / FP32_FUNCS) through ``__amp_list__``. The tags are inert: they
only act inside an ``autocast`` scope, and the scope belongs to O1/O4, which
are not ported yet (``amp.initialize`` raises for them). So here the tags
record the policy and call the op unchanged.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from beforeholiday_tpu_torch.ops.arena import is_namedtuple


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor in a nest of dicts, lists and tuples to
    ``dtype``; other leaves pass through unchanged."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [cast_floats(v, dtype) for v in tree]
        return type(tree)(*vals) if is_namedtuple(tree) else type(tree)(vals)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _tag(fn: Callable, amp_list: str) -> Callable:
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs)

    wrapped.__amp_list__ = amp_list
    return wrapped


def half_function(fn: Callable) -> Callable:
    """Tag an op as low-precision under autocast (FP16_FUNCS /
    BFLOAT16_FUNCS). Inert until O1/O4's autocast scope is ported."""
    return _tag(fn, "half")


def float_function(fn: Callable) -> Callable:
    """Tag an op as fp32-only under autocast (FP32_FUNCS: norms, losses,
    transcendentals). Inert until O1/O4's autocast scope is ported."""
    return _tag(fn, "float")
