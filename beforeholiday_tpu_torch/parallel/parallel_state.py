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
``data_parallel_spec`` (GSPMD) have no counterpart; the two-level, MoE and
elastic mesh carvers (``make_two_level_mesh``, ``make_moe_mesh``,
``carve_data_mesh``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
            raise NotImplementedError(
                f"a collective over several axes ({tuple(axis_name)!r}) is not "
                "ported yet; the two-level (slice, intra) engines come with "
                "ZeRO and the multi-slice mesh")
        axis_name = axis_name[0]
    if not isinstance(axis_name, str):
        return axis_name  # a ProcessGroup
    if not dist.is_initialized():
        raise RuntimeError(
            f"axis {axis_name!r} needs a process group: torch.distributed is "
            "not initialized")
    if _GLOBAL_STATE is not None:
        try:
            return _GLOBAL_STATE.groups[axis_name]
        except KeyError:
            raise ValueError(f"unknown mesh axis {axis_name!r}") from None
    if axis_name == DATA_AXIS:
        return dist.group.WORLD
    raise RuntimeError(
        f"axis {axis_name!r} is unbound: model parallelism is not "
        "initialized (only the data axis defaults to the WORLD group)")


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
