"""Tensor- and sequence-parallel collective mappings — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/mappings.py`` (ref:
apex/transformer/tensor_parallel/mappings.py).

Megatron's conjugate pairs, each a ``torch.autograd.Function`` over the
``monitor.comms`` wrappers, on the process group ``axis_name`` names
(``parallel_state.get_group``):

    f: copy_to_tensor_model_parallel_region     — id fwd  / psum bwd
    g: reduce_from_tensor_model_parallel_region — psum fwd / id bwd
    scatter/gather of the last dim
    the sequence-parallel scatter/gather/reduce-scatter of dim 0

The sequence dim is dim 0 ((s, b, h), Megatron's layout), as in JAX. Each
collective books the JAX package's site name. At a world of one every
mapping is exact: a sum over one rank, a gather of one shard. With
:func:`set_collective_chunk_bytes` set, a gather or reduce-scatter whose
payload exceeds the budget runs as independent chunks
(``parallel.bucketing.chunked_all_gather`` / ``chunked_reduce_scatter``),
bitwise equal to the single collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel import bucketing
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS, get_group

__all__ = [
    "collective_chunk_bytes",
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "set_collective_chunk_bytes",
]

# the TP/SP gathers' and reduce-scatters' chunk budget in bytes; None issues
# each as one collective (the JAX module's process-wide setting)
_CHUNK_BYTES: Optional[int] = None


def set_collective_chunk_bytes(n):
    """Set the TP/SP collective chunk budget (bytes); ``None`` disables.
    Returns the previous value so callers can restore it."""
    global _CHUNK_BYTES
    prev = _CHUNK_BYTES
    if n is not None:
        n = int(n)
        if n <= 0:
            raise ValueError(f"chunk_bytes must be positive, got {n}")
    _CHUNK_BYTES = n
    return prev


def collective_chunk_bytes():
    return _CHUNK_BYTES


def _rank_world(axis_name):
    group = get_group(axis_name)
    return dist.get_rank(group), dist.get_world_size(group)


def _split_along(x, dim, axis_name):
    """This rank's shard of ``x`` along ``dim``."""
    rank, world = _rank_world(axis_name)
    size = x.shape[dim]
    if size % world:
        raise ValueError(f"dim {dim} size {size} not divisible by {world}")
    shard = size // world
    return x.narrow(dim, rank * shard, shard).contiguous()


def _all_gather(x, dim, axis_name, *, site):
    if _CHUNK_BYTES is not None:
        return bucketing.chunked_all_gather(x, axis_name, site=site, dim=dim,
                                            chunk_bytes=_CHUNK_BYTES)
    return comms.all_gather(x, axis_name, site=site, axis=dim, tiled=True)


def _reduce_scatter(x, dim, axis_name, *, site):
    if _CHUNK_BYTES is not None:
        return bucketing.chunked_reduce_scatter(x, axis_name, site=site, dim=dim,
                                                chunk_bytes=_CHUNK_BYTES)
    return comms.psum_scatter(x, axis_name, site=site, scatter_dimension=dim,
                              tiled=True)


# --- f / g conjugates ---------------------------------------------------------


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return comms.psum(dy, ctx.axis_name, site="tp.copy_to_region.bwd"), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return comms.psum(x, axis_name, site="tp.reduce_from_region")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """Identity forward, all-reduce backward (ref: mappings.py:23-45
    ``_CopyToModelParallelRegion``)."""
    return _CopyToRegion.apply(x, axis_name)


def reduce_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """All-reduce forward, identity backward (ref: mappings.py:48-68
    ``_ReduceFromModelParallelRegion``)."""
    return _ReduceFromRegion.apply(x, axis_name)


# --- last-dim scatter/gather (TP activations) ---------------------------------


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _split_along(x, -1, axis_name)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, -1, ctx.axis_name,
                           site="tp.scatter_to_region.bwd"), None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _all_gather(x, -1, axis_name, site="tp.gather_from_region")

    @staticmethod
    def backward(ctx, dy):
        return _split_along(dy, -1, ctx.axis_name), None


def scatter_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """Split the last dim forward, all-gather backward (ref:
    mappings.py:71-99)."""
    return _ScatterToRegion.apply(x, axis_name)


def gather_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """All-gather the last dim forward, split backward (ref:
    mappings.py:102-135)."""
    return _GatherFromRegion.apply(x, axis_name)


# --- sequence-parallel dim-0 mappings (ref: mappings.py:205-260) ----------------


class _ScatterToSequenceRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _split_along(x, 0, axis_name)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, 0, ctx.axis_name,
                           site="sp.scatter_to_region.bwd"), None


class _GatherFromSequenceRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, tp_grad):
        ctx.axis_name, ctx.tp_grad = axis_name, tp_grad
        return _all_gather(x, 0, axis_name, site="sp.gather_from_region")

    @staticmethod
    def backward(ctx, dy):
        if ctx.tp_grad:
            return _reduce_scatter(dy, 0, ctx.axis_name,
                                   site="sp.gather_from_region.bwd"), None, None
        return _split_along(dy, 0, ctx.axis_name), None, None


class _ReduceScatterToSequenceRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _reduce_scatter(x, 0, axis_name, site="sp.reduce_scatter_to_region")

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, 0, ctx.axis_name,
                           site="sp.reduce_scatter_to_region.bwd"), None


def scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS):
    """Split dim 0 forward, all-gather backward (ref:
    ``_ScatterToSequenceParallelRegion``)."""
    return _ScatterToSequenceRegion.apply(x, axis_name)


def gather_from_sequence_parallel_region(x, axis_name=TENSOR_AXIS,
                                         tensor_parallel_output_grad=True):
    """All-gather dim 0 forward; the backward reduce-scatters when the
    consumer is a TP op (each rank holds a partial gradient for every
    token), else splits (ref: ``_GatherFromSequenceParallelRegion``)."""
    return _GatherFromSequenceRegion.apply(x, axis_name,
                                           bool(tensor_parallel_output_grad))


def reduce_scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS):
    """Reduce-scatter dim 0 forward, all-gather backward (ref:
    ``_ReduceScatterToSequenceParallelRegion``)."""
    return _ReduceScatterToSequenceRegion.apply(x, axis_name)
