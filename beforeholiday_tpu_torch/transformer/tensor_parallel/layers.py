"""Tensor-parallel layers — counterpart of
``beforeholiday_tpu/transformer/tensor_parallel/layers.py`` (ref:
apex/transformer/tensor_parallel/layers.py:167-780).

Functional ports of ``VocabParallelEmbedding``, ``ColumnParallelLinear`` and
``RowParallelLinear``: each takes this rank's weight shard and runs on the
tensor group ``axis_name`` names. The weight layout is (in, out), as in JAX:
column-parallel shards ``out``, row-parallel shards ``in``. The product and
the bias are two operations, each rounded to the activation dtype, as JAX
writes them (the GPT's blocks keep ``ops.fused_dense``'s single rounding;
see ``testing/gpt.py``). Under sequence parallelism the gather and the GEMM
can run as the collective matmul (``collective.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor.comms import ledger_scope
from beforeholiday_tpu_torch.parallel.parallel_state import TENSOR_AXIS, get_group
from beforeholiday_tpu_torch.transformer.tensor_parallel import collective as cm
from beforeholiday_tpu_torch.transformer.tensor_parallel import mappings as mp

__all__ = ["column_parallel_linear", "row_parallel_linear",
           "vocab_parallel_embedding", "vocab_range"]

def column_parallel_linear(
    x: torch.Tensor,
    weight: torch.Tensor,  # (in, out/world) local shard
    bias: Optional[torch.Tensor] = None,  # (out/world,) local shard
    *,
    gather_output: bool = False,
    sequence_parallel: bool = False,
    collective_matmul: Optional[bool] = None,
    axis_name: str = TENSOR_AXIS,
) -> torch.Tensor:
    """Y = X @ A with A column-sharded (ref: layers.py:429
    ``ColumnParallelLinear``).

    ``sequence_parallel``: x arrives sequence-sharded (dim 0); it is
    all-gathered before the GEMM and the backward reduce-scatters.
    Otherwise x is replicated and the f-conjugate (identity forward,
    all-reduce backward) applies. ``collective_matmul`` (sequence parallel
    only; None: ``collective.collective_matmul_enabled()``, off unless set)
    runs the gather and the GEMM as the collective matmul's ppermute ring."""
    if gather_output and sequence_parallel:
        raise ValueError("cannot gather output in sequence-parallel mode")
    with ledger_scope("column_parallel_linear"):
        if collective_matmul is None:
            collective_matmul = cm.collective_matmul_enabled()
        if sequence_parallel and collective_matmul:
            y = cm.all_gather_matmul(x, weight.to(x.dtype), axis_name)
        else:
            if sequence_parallel:
                x = mp.gather_from_sequence_parallel_region(x, axis_name, True)
            else:
                x = mp.copy_to_tensor_model_parallel_region(x, axis_name)
            y = x @ weight.to(x.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        if gather_output:
            y = mp.gather_from_tensor_model_parallel_region(y, axis_name)
        return y


def row_parallel_linear(
    x: torch.Tensor,
    weight: torch.Tensor,  # (in/world, out) local shard
    bias: Optional[torch.Tensor] = None,  # (out,) replicated
    *,
    input_is_parallel: bool = True,
    sequence_parallel: bool = False,
    axis_name: str = TENSOR_AXIS,
) -> torch.Tensor:
    """Y = X @ A with A row-sharded (ref: layers.py:613
    ``RowParallelLinear``). The partial products are all-reduced (the
    g-conjugate), or reduce-scattered onto the sequence dim under
    ``sequence_parallel``; the bias is added after the reduction, on full
    values, as the reference adds it."""
    if not input_is_parallel and sequence_parallel:
        raise ValueError("sequence_parallel needs input_is_parallel")
    with ledger_scope("row_parallel_linear"):
        if not input_is_parallel:
            x = mp.scatter_to_tensor_model_parallel_region(x, axis_name)
        y_partial = x @ weight.to(x.dtype)
        if sequence_parallel:
            y = mp.reduce_scatter_to_sequence_parallel_region(y_partial, axis_name)
        else:
            y = mp.reduce_from_tensor_model_parallel_region(y_partial, axis_name)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y


def vocab_range(vocab_size: int, axis_name: str = TENSOR_AXIS) -> Tuple[int, int]:
    """(this rank's first vocab index, local vocab size) — ref:
    ``VocabUtility.vocab_range_from_global_vocab_size`` (layers.py:103-115)."""
    group = get_group(axis_name)
    world = dist.get_world_size(group)
    if vocab_size % world:
        raise ValueError(f"vocab {vocab_size} not divisible by {world}")
    local = vocab_size // world
    return dist.get_rank(group) * local, local


def vocab_parallel_embedding(
    tokens: torch.Tensor,  # (...,) int
    weight: torch.Tensor,  # (vocab/world, hidden) local shard
    *,
    vocab_size: int,
    axis_name: str = TENSOR_AXIS,
) -> torch.Tensor:
    """Vocab-sharded embedding lookup (ref: layers.py:167
    ``VocabParallelEmbedding``): tokens outside this rank's range give zero
    rows, and one all-reduce assembles the embedding; the backward
    scatter-adds into the local shard for the tokens this rank owns."""
    with ledger_scope("vocab_parallel_embedding"):
        start, local = vocab_range(vocab_size, axis_name)
        in_range = (tokens >= start) & (tokens < start + local)
        local_idx = torch.where(in_range, tokens - start, 0)
        out = weight[local_idx]
        out = torch.where(in_range[..., None], out, out.new_zeros(()))
        return mp.reduce_from_tensor_model_parallel_region(out, axis_name)
