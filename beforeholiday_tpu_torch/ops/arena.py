"""Flat arenas — the part of ``beforeholiday_tpu/ops/arena.py`` the paged KV
cache needs.

One flat buffer padded to :data:`TILE` is carved into tensors by a static
offset table. Here the pieces are views of the buffer, so an in-place write
to a piece writes the arena. The full arena API (flatten, packed params,
segment ids) arrives with the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

LANES = 128
# one multi-tensor kernel block (256 rows x 128 lanes) — kept identical to the
# reference so arena offsets and padding match element for element
TILE = 256 * LANES


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Static metadata describing how a tensor list is packed into a flat
    buffer."""

    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    total: int
    padded_total: int


def make_spec(shapes: Sequence[Sequence[int]]) -> ArenaSpec:
    """Spec for a list of tensor shapes (anything with a ``.shape`` is taken
    for its shape), padded to a :data:`TILE` multiple."""
    shapes = tuple(
        tuple(int(d) for d in getattr(s, "shape", s)) for s in shapes
    )
    sizes = [math.prod(s) for s in shapes]
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    padded = -(-off // TILE) * TILE if off else TILE
    return ArenaSpec(shapes, tuple(offsets), off, padded)


def unflatten(flat: torch.Tensor, spec: ArenaSpec) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``spec.shapes`` (no copy)."""
    if flat.ndim != 1 or flat.numel() < spec.total:
        raise ValueError(
            f"flat buffer of shape {tuple(flat.shape)} cannot hold {spec.total}"
        )
    return [
        flat[off: off + math.prod(shape)].view(shape)
        for off, shape in zip(spec.offsets, spec.shapes)
    ]
