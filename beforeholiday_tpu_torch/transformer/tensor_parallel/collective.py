"""Collective matmul: the sequence-parallel all-gather overlapped with the
GEMM it feeds — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/collective.py`` (Wang et
al. 2023, "Overlap Communication with Dependent Computation via
Decomposition").

The sequence-parallel column-parallel forward is ``all_gather(x) @ w``. As
a ring of ``ppermute`` hops (site ``tp.collective_matmul:hop{t}``), step t
multiplies the chunk that rank ``(rank - t) mod world`` contributed and
writes it at that rank's offset of the gathered layout. Each hop is posted
before the GEMM of the chunk in hand and waited on after it, so the GEMM
runs while the next chunk is on the wire (on NCCL the transfer runs on the
communicator's stream beside the compute stream). Every row of the product
is the monolithic GEMM's row; whether a GEMM library returns it bit for
bit at another row count is the library's business (``PERF.md`` records
the card's answer).

The backward is the monolithic path's: ``dx`` is the cotangent GEMM
reduce-scattered through ``mappings``' helper (site
``tp.collective_matmul.bwd_dx``), ``dw`` the gathered activation's
contraction with the cotangent, both as the folded 2-D GEMMs autograd runs
for ``x @ w``. The gathered activation, assembled from the same hops, is
the residual. Off by default: :func:`set_collective_matmul`, or
``column_parallel_linear(collective_matmul=True)``, turns it on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS, get_group
from beforeholiday_tpu_torch.transformer.tensor_parallel import mappings as mp

__all__ = [
    "all_gather_matmul",
    "collective_matmul_enabled",
    "set_collective_matmul",
]

_ENABLED = False


def set_collective_matmul(enabled: bool) -> bool:
    """Set the module-wide default of the ``collective_matmul`` knob of the
    sequence-parallel column-parallel layers; returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def collective_matmul_enabled() -> bool:
    return _ENABLED


def _mm(a, b):
    """``a @ b`` for a of any rank as autograd runs it: one 2-D GEMM over
    a's folded leading dims."""
    return a.reshape(-1, a.shape[-1]).mm(b).reshape(*a.shape[:-1], b.shape[-1])


def _ring_gather_matmul(x, w, axis_name):
    """``(all_gather(x) @ w, all_gather(x))`` from one ring pass: after t
    hops of the (i -> i + 1) ring this rank holds rank ``(rank - t) mod
    world``'s chunk, written at that rank's offset."""
    group = get_group(axis_name)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    s = x.shape[0]
    y = x.new_empty((world * s, *x.shape[1:-1], w.shape[1]))
    xg = x.new_empty((world * s, *x.shape[1:]))
    perm = [(i, (i + 1) % world) for i in range(world)]

    def post(chunk, t):
        return comms.ppermute(chunk, axis_name, perm, async_op=True,
                              site=f"tp.collective_matmul:hop{t}")

    # hop t + 1 is posted before chunk t's GEMM and waited on after it
    pending = post(x, 1) if world > 1 else None
    y[rank * s:(rank + 1) * s] = _mm(x, w)
    xg[rank * s:(rank + 1) * s] = x
    for t in range(1, world):
        cur, work = pending
        work.wait()
        pending = post(cur, t + 1) if t + 1 < world else None
        src = (rank - t) % world
        y[src * s:(src + 1) * s] = _mm(cur, w)
        xg[src * s:(src + 1) * s] = cur
    return y, xg


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis_name):
        y, xg = _ring_gather_matmul(x, w, axis_name)
        ctx.save_for_backward(xg, w)
        ctx.axis_name = axis_name
        return y

    @staticmethod
    def backward(ctx, dy):
        xg, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dxg = dy2.mm(w.t()).reshape(xg.shape).to(xg.dtype)
        dx = mp._reduce_scatter(dxg, 0, ctx.axis_name,
                                site="tp.collective_matmul.bwd_dx")
        dw = xg.reshape(-1, xg.shape[-1]).t().mm(dy2).to(w.dtype)
        return dx, dw, None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor,
                      axis_name: str = TENSOR_AXIS) -> torch.Tensor:
    """``all_gather(x, dim 0) @ w`` as a ring of ppermute hops, with the
    sequence-parallel backward (``dx`` reduce-scattered, Megatron's
    ``tensor_parallel_output_grad=True``). x: this rank's ``(s_local, ...,
    K)`` sequence chunk; w: its ``(K, N)`` column shard; returns
    ``(s_local * world, ..., N)``."""
    return _AllGatherMatmul.apply(x, w, axis_name)
