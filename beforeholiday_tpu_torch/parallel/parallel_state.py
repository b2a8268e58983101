"""Process-group state — counterpart of
``beforeholiday_tpu/parallel/parallel_state.py``.

The JAX package lays the devices out as ONE mesh of shape (pipe, data,
context, tensor), tensor fastest-varying, and a collective names a mesh
axis. Here the world is ``torch.distributed``'s (NCCL on the card, gloo on
the CPU; the caller initializes it) and an axis is a ``ProcessGroup``:
:func:`initialize_model_parallel` lays the global ranks out in the mesh's
order, ``rank = ((pipe * dp + data) * cp + context) * tp + tensor``, and
creates one group per line of each axis with ``dist.new_group``. Every
collective of the port takes an ``axis_name`` and resolves it through
:func:`get_group`: an axis name (the data axis is the ``WORLD`` group until
model parallelism is initialized), or a ``ProcessGroup`` itself;
``axis_index_groups`` become subgroups of it.

A rank is a process here, so the rank getters return this process's
group-local rank (JAX returns ``axis_index`` inside ``shard_map``, and 0
outside it). The error paths are the JAX module's: an indivisible world,
and a virtual pipeline without pp >= 2. ``named_sharding`` and
``data_parallel_spec`` (GSPMD) have no counterpart.

The mesh carvers (:func:`make_two_level_mesh`, :func:`make_moe_mesh`,
:func:`carve_data_mesh`) install no global state, as in JAX: each returns a
:class:`Mesh` holding this process's group on each of its axes, and a
collective resolves the mesh's axis names while the mesh is active (``with
mesh:``, the counterpart of ``shard_map`` over it). Every rank of the world
creates every group of a mesh, in one order, whether it is in the mesh or
not. A two-element spec such as ``("slice", "intra")`` names the pair of
groups (:func:`get_groups`); one collective over it runs on the mesh's joint
group, whose ranks are the mesh's in mesh order (:func:`get_group`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"
CONTEXT_AXIS = "context"

MESH_AXIS_NAMES = (PIPE_AXIS, DATA_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

SLICE_AXIS = "slice"
INTRA_AXIS = "intra"
HIERARCHICAL_AXES = (SLICE_AXIS, INTRA_AXIS)
EXPERT_AXIS = "expert"
MOE_MESH_AXIS_NAMES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, TENSOR_AXIS)


@dataclasses.dataclass(frozen=True)
class ParallelState:
    """Snapshot of the global parallel layout. ``rank_grid`` holds the
    global ranks in the mesh's shape (pipe, data, context, tensor);
    ``groups`` this process's group on each axis and ``group_ranks`` its
    members, in axis order."""

    rank_grid: np.ndarray
    tensor_model_parallel_size: int
    pipeline_model_parallel_size: int
    data_parallel_size: int
    context_parallel_size: int
    virtual_pipeline_model_parallel_size: Optional[int]
    pipeline_model_parallel_split_rank: Optional[int]
    groups: Dict[str, Any]
    group_ranks: Dict[str, Tuple[int, ...]]


_GLOBAL_STATE: Optional[ParallelState] = None
_VIRTUAL_PIPELINE_RANK: Optional[int] = None
# every group this module created, to destroy with the state
_CREATED: list = []
# (axis label, base group ranks, axis_index_groups) -> this rank's subgroup
_SUBGROUPS: Dict[tuple, Any] = {}


def _new_group(ranks):
    group = dist.new_group(list(ranks))
    _CREATED.append(group)
    return group


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    *,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_split_rank: Optional[int] = None,
    context_parallel_size: int = 1,
) -> ParallelState:
    """Lay the ``torch.distributed`` world out as (pipe, data, context,
    tensor) and create each axis's groups. Every rank must call it, with
    the same sizes (``new_group`` is collective). Calling it again
    re-initializes, as in the JAX package."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "dist.init_process_group before initialize_model_parallel")
    world = dist.get_world_size()
    tp, pp, cp = (tensor_model_parallel_size, pipeline_model_parallel_size,
                  context_parallel_size)
    if world % (tp * pp * cp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor ({tp}) x "
            f"pipeline ({pp}) x context ({cp}) parallel sizes"
        )
    dp = world // (tp * pp * cp)
    if virtual_pipeline_model_parallel_size is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size should be greater than 1 with "
            "interleaved schedule"
        )
    destroy_model_parallel()
    grid = np.arange(world).reshape(pp, dp, cp, tp)
    me = dist.get_rank()
    groups, members = {}, {}
    for axis, name in enumerate(MESH_AXIS_NAMES):
        # the lines along this axis, in a fixed order on every rank
        lines = np.moveaxis(grid, axis, -1).reshape(-1, grid.shape[axis])
        for line in lines:
            ranks = tuple(int(r) for r in line)
            group = _new_group(ranks)
            if me in ranks:
                groups[name], members[name] = group, ranks

    global _GLOBAL_STATE, _VIRTUAL_PIPELINE_RANK
    _VIRTUAL_PIPELINE_RANK = (0 if virtual_pipeline_model_parallel_size
                              is not None else None)
    _GLOBAL_STATE = ParallelState(
        rank_grid=grid,
        tensor_model_parallel_size=tp,
        pipeline_model_parallel_size=pp,
        data_parallel_size=dp,
        context_parallel_size=cp,
        virtual_pipeline_model_parallel_size=virtual_pipeline_model_parallel_size,
        pipeline_model_parallel_split_rank=pipeline_model_parallel_split_rank,
        groups=groups,
        group_ranks=members,
    )
    return _GLOBAL_STATE


def destroy_model_parallel() -> None:
    """Drop the state and destroy the groups this module created."""
    global _GLOBAL_STATE, _VIRTUAL_PIPELINE_RANK
    _GLOBAL_STATE = None
    _VIRTUAL_PIPELINE_RANK = None
    if dist.is_initialized():
        for group in _CREATED:
            dist.destroy_process_group(group)
    _CREATED.clear()
    _SUBGROUPS.clear()


def model_parallel_is_initialized() -> bool:
    return _GLOBAL_STATE is not None


def _state() -> ParallelState:
    if _GLOBAL_STATE is None:
        raise RuntimeError(
            "parallel state is not initialized — call "
            "initialize_model_parallel() first"
        )
    return _GLOBAL_STATE


def get_state() -> ParallelState:
    return _state()


def get_rank_grid() -> np.ndarray:
    """The global ranks in the mesh's shape (pipe, data, context, tensor):
    what ``get_mesh()`` holds in the JAX package."""
    return _state().rank_grid


# --- axis -> group ------------------------------------------------------


def hierarchical_axes(axis_name):
    """A ``(slice_axis, intra_axis)`` pair for a two-level spec, or None for
    a flat one (an axis name, a one-element sequence, or a
    ``ProcessGroup``). Longer sequences are rejected, as in JAX."""
    if isinstance(axis_name, (tuple, list)):
        if len(axis_name) == 1:
            return None
        if len(axis_name) != 2:
            raise ValueError(
                "a hierarchical axis spec must be (slice_axis, intra_axis); "
                f"got {tuple(axis_name)!r}"
            )
        return (str(axis_name[0]), str(axis_name[1]))
    return None


def _base_group(axis_name):
    if isinstance(axis_name, (tuple, list)):
        if len(axis_name) != 1:
            hierarchical_axes(axis_name)  # more than two axes: ValueError
            return _joint_group(tuple(str(a) for a in axis_name))
        axis_name = axis_name[0]
    if not isinstance(axis_name, str):
        return axis_name  # a ProcessGroup
    if not dist.is_initialized():
        raise RuntimeError(
            f"axis {axis_name!r} needs a process group: torch.distributed is "
            "not initialized")
    mesh = active_mesh()
    if mesh is not None and axis_name in mesh.axis_names:
        return mesh.group_of(axis_name)
    if _GLOBAL_STATE is not None:
        try:
            return _GLOBAL_STATE.groups[axis_name]
        except KeyError:
            raise ValueError(f"unknown mesh axis {axis_name!r}") from None
    if axis_name == DATA_AXIS:
        return dist.group.WORLD
    raise RuntimeError(
        f"axis {axis_name!r} is unbound: model parallelism is not "
        "initialized and no active mesh names it (only the data axis "
        "defaults to the WORLD group)")


def _joint_group(axes: Tuple[str, ...]):
    """The one group a collective over several axes runs on: the active
    mesh's joint group when ``axes`` are all of its axes in mesh order."""
    mesh = active_mesh()
    if mesh is None or tuple(a for a in mesh.axis_names if a in axes) != axes \
            or set(axes) != set(mesh.axis_names):
        raise ValueError(
            f"a collective over {axes!r} needs an active mesh whose axes are "
            f"exactly these, in this order (active: "
            f"{None if mesh is None else mesh.axis_names!r})")
    return mesh.joint_group()


def get_groups(axis_name: Any):
    """The groups of a spec, one per axis: a pair for ``("slice",
    "intra")``, a one-tuple for a flat axis."""
    axes = hierarchical_axes(axis_name)
    if axes is None:
        return (get_group(axis_name),)
    return tuple(_base_group(a) for a in axes)


def get_group(axis_name: Any = DATA_AXIS, axis_index_groups=None):
    """The ``ProcessGroup`` an ``axis_name`` names (see the module
    docstring). ``axis_index_groups`` (lists of indices along the axis, as
    ``lax.psum`` takes them) give this rank's subgroup; every rank must make
    the same call, since the subgroups are created collectively the first
    time."""
    base = _base_group(axis_name)
    if axis_index_groups is None:
        return base
    base_ranks = tuple(dist.get_process_group_ranks(base))
    key = (base_ranks, tuple(tuple(int(i) for i in g) for g in axis_index_groups))
    if key not in _SUBGROUPS:
        me, mine = dist.get_rank(), None
        for idx in key[1]:
            ranks = [base_ranks[i] for i in idx]
            group = _new_group(ranks)
            if me in ranks:
                mine = group
        if mine is None:
            raise ValueError(f"rank {me} is in none of {axis_index_groups!r}")
        _SUBGROUPS[key] = mine
    return _SUBGROUPS[key]


# --- meshes carved from the world -----------------------------------------


class Mesh:
    """A set of global ranks laid out on named axes, with this process's
    group on each axis and the joint group of the whole mesh (every rank of
    the world created every group, in one order). ``ranks`` holds the global
    ranks in the mesh's shape, ascending in flat order, so a group's local
    rank is the mesh index along it. Entering the mesh (``with mesh:``)
    makes its axis names resolve for every collective of the port, as
    ``shard_map`` over a JAX mesh binds them; it installs no model-parallel
    state. A rank outside the mesh holds no group and raises on use."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"ranks of shape {self.ranks.shape} for axes "
                             f"{self.axis_names!r}")
        flat = self.ranks.reshape(-1)
        if flat.size > 1 and not bool(np.all(np.diff(flat) > 0)):
            raise ValueError("a mesh's ranks must ascend in flat order (a "
                             "process group orders its members by rank)")
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        self.index = (None if where.size == 0
                      else dict(zip(self.axis_names, (int(i) for i in where[0]))))
        self._groups: Dict[str, Any] = {}
        self._created = []
        for axis, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, axis, -1).reshape(
                -1, self.ranks.shape[axis])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                self._created.append(group)
                if me in line:
                    self._groups[name] = group
        self._joint = dist.new_group([int(r) for r in flat])
        self._created.append(self._joint)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def _member(self):
        if self.index is None:
            raise RuntimeError(
                f"rank {dist.get_rank()} is not in this mesh (ranks "
                f"{self.ranks.reshape(-1).tolist()})")

    def group_of(self, axis: str):
        """This rank's group along ``axis``."""
        self._member()
        return self._groups[axis]

    def joint_group(self):
        """The group of every rank of the mesh, in mesh order."""
        self._member()
        return self._joint

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``; for a sequence of axes, the
        flat index over them (``slice * slice_size + intra``)."""
        self._member()
        if isinstance(axis, (tuple, list)):
            idx = 0
            for a in axis:
                idx = idx * self.shape[a] + self.index[a]
            return idx
        return self.index[axis]

    def __enter__(self):
        _ACTIVE_MESHES.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE_MESHES.remove(self)
        return False

    def destroy(self) -> None:
        """Destroy the mesh's groups (every rank, as with ``new_group``)."""
        while self in _ACTIVE_MESHES:
            _ACTIVE_MESHES.remove(self)
        for group in self._created:
            if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(group)
        self._created.clear()
        self._groups.clear()
        self._joint = None


# the entered meshes, innermost last: process-wide, since the autograd
# engine runs a CUDA backward (and the overlap hooks in it) on its own thread
_ACTIVE_MESHES: list = []


def active_mesh() -> Optional[Mesh]:
    """The innermost entered :class:`Mesh`, or None."""
    return _ACTIVE_MESHES[-1] if _ACTIVE_MESHES else None


def _mesh_ranks(ranks: Optional[Sequence[int]]) -> np.ndarray:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "dist.init_process_group before carving a mesh")
    if ranks is None:
        return np.arange(dist.get_world_size())
    return np.asarray(list(ranks), dtype=np.int64).reshape(-1)


def make_two_level_mesh(n_slices: int, slice_size: Optional[int] = None, *,
                        ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ``(slice, intra)`` mesh of ``n_slices`` slices of ``slice_size``
    ranks, slice-major, so the flat data-parallel rank is ``slice *
    slice_size + intra``: the order a flat ``(data,)`` mesh over the same
    ranks has. ``slice_size`` defaults to ``len(ranks) // n_slices``;
    ``ranks`` to the whole world. Installs no global state."""
    ranks = _mesh_ranks(ranks)
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if slice_size is None:
        if len(ranks) % n_slices != 0:
            raise RuntimeError(f"device count ({len(ranks)}) is not divisible "
                               f"by n_slices ({n_slices})")
        slice_size = len(ranks) // n_slices
    world = n_slices * slice_size
    if len(ranks) < world:
        raise RuntimeError(f"need {world} devices for a {n_slices}x{slice_size} "
                           f"mesh, have {len(ranks)}")
    return Mesh(ranks[:world].reshape(n_slices, slice_size), HIERARCHICAL_AXES)


def make_moe_mesh(data: int = 1, tensor: int = 1, pipeline: int = 1,
                  expert: int = 1, *, ranks: Optional[Sequence[int]] = None
                  ) -> Mesh:
    """A data x tensor x pipeline x expert mesh in ``MOE_MESH_AXIS_NAMES``
    order ``(pipe, data, expert, tensor)``, tensor fastest. Size-1 axes are
    dropped, as the two-level engines drop size-1 tiers, so a collective
    over an absent axis fails loudly; an all-ones carve is a one-rank
    ``(data,)`` mesh. Installs no global state."""
    ranks = _mesh_ranks(ranks)
    sizes = {PIPE_AXIS: pipeline, DATA_AXIS: data, EXPERT_AXIS: expert,
             TENSOR_AXIS: tensor}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"{name} size must be >= 1, got {n}")
    world = pipeline * data * expert * tensor
    if len(ranks) < world:
        raise RuntimeError(
            f"need {world} devices for a pipe={pipeline} x data={data} x "
            f"expert={expert} x tensor={tensor} mesh, have {len(ranks)}")
    kept = [(name, sizes[name]) for name in MOE_MESH_AXIS_NAMES if sizes[name] > 1]
    if not kept:
        kept = [(DATA_AXIS, 1)]
    return Mesh(ranks[:world].reshape([n for _, n in kept]),
                tuple(name for name, _ in kept))


def carve_data_mesh(world: int, *, ranks: Optional[Sequence[int]] = None,
                    axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D ``(axis_name,)`` mesh over the first ``world`` ranks of
    ``ranks`` (default the whole world), in order: the surviving world an
    elastic resize builds. Installs no global state."""
    ranks = _mesh_ranks(ranks)
    if not 1 <= world <= ranks.size:
        raise ValueError(f"cannot carve a world-{world} data mesh from "
                         f"{ranks.size} device(s); world must be in "
                         "[1, len(devices)]")
    return Mesh(ranks[:world], (axis_name,))


# --- world sizes ------------------------------------------------------------


def get_tensor_model_parallel_world_size() -> int:
    return _state().tensor_model_parallel_size


def get_pipeline_model_parallel_world_size() -> int:
    return _state().pipeline_model_parallel_size


def get_data_parallel_world_size() -> int:
    return _state().data_parallel_size


def get_context_parallel_world_size() -> int:
    return _state().context_parallel_size


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _state().virtual_pipeline_model_parallel_size


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _state().pipeline_model_parallel_split_rank


# --- ranks --------------------------------------------------------------------


def _axis_rank(axis: str) -> int:
    """This process's index along ``axis``; 0 on an axis of size 1 when
    model parallelism is not initialized (the data axis is then the
    world)."""
    if _GLOBAL_STATE is not None:
        return _GLOBAL_STATE.group_ranks[axis].index(dist.get_rank())
    if axis == DATA_AXIS and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPE_AXIS)


def get_data_parallel_rank() -> int:
    return _axis_rank(DATA_AXIS)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PIPELINE_RANK
    _VIRTUAL_PIPELINE_RANK = rank


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """With a virtual pipeline only chunk 0 on pipe rank 0 is the first
    stage."""
    if not ignore_virtual:
        vpp = get_virtual_pipeline_model_parallel_world_size()
        if vpp is not None and _VIRTUAL_PIPELINE_RANK != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    """With a virtual pipeline only the last chunk on the last pipe rank is
    the last stage."""
    if not ignore_virtual:
        vpp = get_virtual_pipeline_model_parallel_world_size()
        if (vpp is not None and _VIRTUAL_PIPELINE_RANK is not None
                and _VIRTUAL_PIPELINE_RANK != vpp - 1):
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


def is_pipeline_stage_before_split(rank=None) -> bool:
    """True if the stage holds encoder layers."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    split = get_pipeline_model_parallel_split_rank()
    if split is None:
        return True
    r = get_pipeline_model_parallel_rank() if rank is None else rank
    return r < split


def is_pipeline_stage_after_split(rank=None) -> bool:
    """True if the stage holds decoder layers."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    split = get_pipeline_model_parallel_split_rank()
    if split is None:
        return True
    r = get_pipeline_model_parallel_rank() if rank is None else rank
    return r >= split


def is_pipeline_stage_at_split() -> bool:
    """True on the stage that feeds the encoder's output to the decoder."""
    rank = get_pipeline_model_parallel_rank()
    return is_pipeline_stage_before_split(rank) and is_pipeline_stage_after_split(rank + 1)


def get_pipeline_model_parallel_next_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() + 1) % pp


def get_pipeline_model_parallel_prev_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() - 1) % pp


def get_rank_info():
    """(data, tensor, pipe, context) ranks of this process, for logs;
    (0, 0, 0, 0) without the state, as in JAX."""
    if _GLOBAL_STATE is None:
        return (0, 0, 0, 0)
    return (get_data_parallel_rank(), get_tensor_model_parallel_rank(),
            get_pipeline_model_parallel_rank(), get_context_parallel_rank())
