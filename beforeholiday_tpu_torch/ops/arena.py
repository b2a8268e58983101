"""Flat arenas — counterpart of ``beforeholiday_tpu/ops/arena.py``.

One flat buffer padded to :data:`TILE` is carved into tensors by a static
offset table. Offsets and padding are identical to the JAX arena, so the two
arenas compare element by element. Here the pieces are views of the buffer,
so an in-place write to a piece writes the arena, and an optimizer that
updates an arena in place updates every piece the model reads.

:class:`PackedParams` stores a parameter tree as one arena per dtype. The
JAX package gets gradient arenas from ``jax.grad`` at a packed argument; in
PyTorch the same "grads born flat" property comes from
:meth:`PackedParams.grad_leaves`: every piece the model reads is a leaf view
of the arena whose ``.grad`` is already the matching view of one flat,
zeroed gradient arena, so autograd accumulates straight into the arena.
Leaves under a :data:`STACKED_KEY` key carry a leading layer axis (the
repo's stacked-layer convention) and get one leaf per layer, so a model that
reads layer ``i`` as ``w[i]`` never makes autograd build a zero tensor of the
whole stack for each layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import torch

LANES = 128
# one multi-tensor kernel block (256 rows x 128 lanes) — kept identical to the
# reference so arena offsets and padding match element for element
TILE = 256 * LANES
# leaves below this key have a leading layer axis (testing/gpt.py "blocks")
STACKED_KEY = "blocks"


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Static metadata describing how a tensor list is packed into a flat
    buffer."""

    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    total: int
    padded_total: int

    @property
    def num_tensors(self) -> int:
        return len(self.shapes)


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


def flatten(tensors: Sequence[torch.Tensor], dtype=None
            ) -> Tuple[torch.Tensor, ArenaSpec]:
    """Pack a tensor list into one new flat buffer padded to :data:`TILE`
    (``apex_C.flatten``). All tensors share a dtype unless ``dtype`` casts."""
    if not tensors:
        raise ValueError("flatten() requires a non-empty tensor list")
    spec = make_spec(tensors)
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors:
            if t.dtype != dtype:
                raise ValueError(
                    f"mixed dtypes in arena ({t.dtype} vs {dtype}); bucket by "
                    "dtype first or pass dtype="
                )
    return views_to_arena(tensors, spec, dtype=dtype), spec


def unflatten(flat: torch.Tensor, spec: ArenaSpec, dtype=None
              ) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``spec.shapes`` (no copy unless ``dtype``
    asks for a cast)."""
    if flat.ndim != 1 or flat.numel() < spec.total:
        raise ValueError(
            f"flat buffer of shape {tuple(flat.shape)} cannot hold {spec.total}"
        )
    out = [
        flat[off: off + math.prod(shape)].view(shape)
        for off, shape in zip(spec.offsets, spec.shapes)
    ]
    return out if dtype is None else [p.to(dtype) for p in out]


def views_to_arena(pieces: Sequence[torch.Tensor], spec: ArenaSpec,
                   dtype=None) -> torch.Tensor:
    """Reassemble per-tensor pieces into a new flat padded arena — the
    inverse of :func:`unflatten`."""
    if len(pieces) != len(spec.shapes):
        raise ValueError(
            f"{len(pieces)} pieces for a {len(spec.shapes)}-tensor spec"
        )
    dtype = pieces[0].dtype if dtype is None else dtype
    flat = torch.empty(spec.padded_total, dtype=dtype, device=pieces[0].device)
    for p, off, shape in zip(pieces, spec.offsets, spec.shapes):
        flat[off: off + math.prod(shape)].copy_(p.reshape(-1))
    flat[spec.total:].zero_()
    return flat


def is_arena(t: torch.Tensor) -> bool:
    """True for a 1-D contiguous buffer already padded to :data:`TILE` —
    a list holding only it needs no packing."""
    return t.ndim == 1 and t.is_contiguous() and t.numel() % TILE == 0


# ----------------------------------------------------------------- trees
#
# A parameter tree is a nest of dicts (keys visited in sorted order, as
# jax.tree_util flattens a dict), lists, tuples and namedtuples (fields in
# their declared order, the type kept, as JAX keeps it) with tensor leaves.
# Paths are tuples of dict keys, namedtuple field names and sequence indices.


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with the JAX package's leaf order."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        keys = sorted(tree)
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, (dict, tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            sub, d = tree_flatten(v)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree), len(tree), tuple(defs))
    return [tree], None


def tree_unflatten(treedef, leaves: Sequence[Any]):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        if kind is dict:
            return {k: build(s) for k, s in zip(keys, subs)}
        vals = [build(s) for s in subs]
        if kind is list:
            return vals
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_paths(tree, prefix=()) -> List[Tuple[Any, ...]]:
    """The path of every leaf, in :func:`tree_flatten` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]
    if is_namedtuple(tree):
        return [p for k, v in zip(type(tree)._fields, tree)
                for p in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [prefix]


def tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# ---------------------------------------------------------- PackedParams


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def bucket_by_dtype(leaves: Sequence[torch.Tensor]):
    """Partition leaf indices into per-dtype buckets, sorted by dtype name —
    the bucketing contract shared by :class:`PackedParams` and
    ``MasterWeights`` (gradient arenas align bucket for bucket with the
    master and optimizer-state arenas). Rejects non-floating leaves."""
    buckets: dict = {}
    for i, p in enumerate(leaves):
        if not p.is_floating_point():
            raise ValueError(
                f"cannot pack non-floating leaf #{i} (dtype {p.dtype}) into "
                "a parameter arena; keep integer leaves out of the optimized "
                "tree"
            )
        buckets.setdefault(p.dtype, []).append(i)
    return sorted(buckets.items(), key=lambda kv: _dtype_name(kv[0]))


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static layout of a params tree packed into per-dtype arenas."""

    treedef: Any
    dtypes: Tuple[torch.dtype, ...]  # one dtype per bucket
    indices: Tuple[Tuple[int, ...], ...]  # leaf indices per bucket
    specs: Tuple[ArenaSpec, ...]  # arena spec per bucket
    n_leaves: int
    stacked: Tuple[bool, ...] = ()  # per leaf: below STACKED_KEY


class PackedParams:
    """A params tree stored as per-dtype flat arenas (the arena-native
    storage of ``amp.initialize(..., arena_native=True)``). The arenas are
    the source of truth: :meth:`unpack` hands out views, and an in-place
    update of an arena is seen by every view."""

    __slots__ = ("arenas", "layout")

    def __init__(self, arenas: Sequence[torch.Tensor], layout: PackedLayout):
        self.arenas = tuple(arenas)
        self.layout = layout

    @classmethod
    def pack(cls, tree: Any) -> "PackedParams":
        """One-time pack (init or checkpoint load, never per step)."""
        leaves, treedef = tree_flatten(tree)
        stacked = tuple(STACKED_KEY in p for p in tree_paths(tree))
        arenas, dtypes, indices, specs = [], [], [], []
        for dtype, idx in bucket_by_dtype(leaves):
            flat, spec = flatten([leaves[i] for i in idx])
            arenas.append(flat)
            dtypes.append(dtype)
            indices.append(tuple(idx))
            specs.append(spec)
        layout = PackedLayout(
            treedef=treedef, dtypes=tuple(dtypes), indices=tuple(indices),
            specs=tuple(specs), n_leaves=len(leaves), stacked=stacked,
        )
        return cls(arenas, layout)

    def _leaves(self, arenas) -> List[torch.Tensor]:
        lay = self.layout
        leaves: List[Any] = [None] * lay.n_leaves
        for buf, idx, spec in zip(arenas, lay.indices, lay.specs):
            for i, piece in zip(idx, unflatten(buf, spec)):
                leaves[i] = piece
        return leaves

    def unpack(self) -> Any:
        """The leaf tree as views of the arenas (no copy)."""
        return tree_unflatten(self.layout.treedef, self._leaves(self.arenas))

    def replace_arenas(self, arenas: Sequence[torch.Tensor]) -> "PackedParams":
        if len(arenas) != len(self.arenas):
            raise ValueError(
                f"expected {len(self.arenas)} arenas, got {len(arenas)}"
            )
        return PackedParams(arenas, self.layout)

    def zeros_like(self) -> "PackedParams":
        """Zeroed arenas of the same layout and dtypes (one memset each)."""
        return self.replace_arenas([torch.zeros_like(a) for a in self.arenas])

    def grad_leaves(self, grads: "PackedParams") -> "_GradPacked":
        """A packed view of these arenas whose :meth:`unpack` returns leaf
        tensors that require grad and whose ``.grad`` are views of
        ``grads``'s arenas, so a backward pass accumulates straight into
        them. Stacked leaves come back as a tuple of one leaf per layer.
        The arenas must be zero (or hold what the backward should add to)."""
        if grads.layout != self.layout:
            raise ValueError("params/grads PackedParams layouts differ")
        leaves, pieces_at = [], []
        where = {}  # leaf index -> (arena, offset)
        for b, (idx, spec) in enumerate(zip(self.layout.indices, self.layout.specs)):
            for i, off in zip(idx, spec.offsets):
                where[i] = (b, off)
        for i, (stacked, p, g) in enumerate(zip(
                self.layout.stacked, self._leaves(self.arenas),
                self._leaves(grads.arenas))):
            pieces = (list(zip(p.unbind(0), g.unbind(0))) if stacked
                      else [(p, g)])
            b, off = where[i]
            out = []
            for pv, gv in pieces:
                leaf = pv.detach().requires_grad_(True)
                leaf.grad = gv
                out.append(leaf)
                pieces_at.append((b, off, gv.numel(), leaf))
                off += gv.numel()
            leaves.append(tuple(out) if stacked else out[0])
        return _GradPacked(self, tree_unflatten(self.layout.treedef, leaves),
                           grads, tuple(pieces_at))


class _GradPacked(PackedParams):
    """What :meth:`PackedParams.grad_leaves` returns: the same arenas, with
    an :meth:`unpack` that hands out the gradient-accumulating leaves.
    ``grads`` is the gradient PackedParams the leaves accumulate into, and
    ``pieces`` lists each leaf as ``(arena index, offset, numel, leaf)``
    (the backward-time reduction hooks use them)."""

    __slots__ = ("_tree", "grads", "pieces")

    def __init__(self, base: PackedParams, tree, grads, pieces):
        super().__init__(base.arenas, base.layout)
        self._tree = tree
        self.grads = grads
        self.pieces = pieces

    def unpack(self) -> Any:
        return self._tree
