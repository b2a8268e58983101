"""Dtype helpers — the part of ``beforeholiday_tpu/ops/_autocast.py`` the
serving path needs.

Only :func:`cast_floats` is ported: the serving engine's one-time weight
cast. The autocast scope and the per-op decorators belong to amp, which
arrives with the training slice.
"""

from __future__ import annotations

import torch


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor in a nest of dicts, lists and tuples to
    ``dtype``; other leaves pass through unchanged."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
