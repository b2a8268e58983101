"""The per-rank tensor-parallel pieces the test models (``gpt.py``,
``bert.py``) share: cutting a parameter tree into a rank's shard along the
model's ``param_specs`` and joining the shards again, and the Megatron
layout's regions (column-parallel inputs, row-parallel outputs and biases,
the sequence-parallel LayerNorm) and rank places of the dropout masks. A
model config here is any with ``n_heads``, ``head_dim``, ``vocab_size``,
``ff``, ``n_layers``, ``d_model``, ``sequence_parallel``, ``norm_impl``
and ``dropout_impl``."""

from __future__ import annotations

from typing import Optional

import torch

from beforeholiday_tpu_torch.ops.attention import RankPlace
from beforeholiday_tpu_torch.parallel import parallel_state
from beforeholiday_tpu_torch.transformer.layers.layer_norm import sp_fused_layer_norm
from beforeholiday_tpu_torch.transformer.tensor_parallel import mappings as mp
from beforeholiday_tpu_torch.transformer.tensor_parallel.random import dropout

TENSOR = parallel_state.TENSOR_AXIS


def _qkv_heads(t: torch.Tensor, cfg) -> torch.Tensor:
    """``wqkv``'s (..., 3D) or ``bqkv``'s (..., 3D) columns as (..., 3, H,
    head_dim): [q | k | v], each over every head."""
    return t.reshape(*t.shape[:-1], 3, cfg.n_heads, cfg.head_dim)


def shard_tree(params: dict, specs: dict, cfg, tp_rank: int, tp_size: int,
               pp_rank: int = 0, pp_size: int = 1) -> dict:
    """The shard of ``params`` (or of any tree of the same layout, such as
    gradients or masters) that tensor rank ``tp_rank`` of ``tp_size`` and
    pipe rank ``pp_rank`` of ``pp_size`` hold: the pipe rank's layers of
    each block leaf, cut along the tensor dim of ``specs`` (the model's
    ``param_specs``); the other leaves whole on every pipe rank. ``wqkv``/``bqkv`` are cut by heads: a
    rank holds its heads' q, k and v columns ([q | k | v] over its heads),
    where a contiguous cut of the last dim would hand rank 0 all of q.
    Copies, so the shard owns its storage."""
    if cfg.n_heads % tp_size or cfg.vocab_size % tp_size or cfg.ff % tp_size:
        raise ValueError(f"heads {cfg.n_heads}, vocab {cfg.vocab_size} and d_ff "
                         f"{cfg.ff} must divide by the tensor size {tp_size}")
    if cfg.n_layers % pp_size:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by the pipe "
                         f"size {pp_size}")
    per = cfg.n_layers // pp_size
    lo = pp_rank * per
    hl = cfg.n_heads // tp_size

    def cut(name, leaf, spec):
        if name in ("wqkv", "bqkv"):
            heads = _qkv_heads(leaf, cfg)[..., tp_rank * hl:(tp_rank + 1) * hl, :]
            return heads.reshape(*leaf.shape[:-1], 3 * hl * cfg.head_dim)
        if TENSOR in spec:
            dim = spec.index(TENSOR)
            n = leaf.shape[dim] // tp_size
            return leaf.narrow(dim, tp_rank * n, n)
        return leaf

    out = {k: cut(k, v, specs[k]).clone() for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: cut(k, v[lo:lo + per], specs["blocks"][k]).clone()
                     for k, v in params["blocks"].items()}
    return out


def unshard_tree(shards, specs: dict, cfg) -> dict:
    """The whole tree from ``shards[pp_rank][tp_rank]`` (every rank's
    :func:`shard_tree`): the inverse of :func:`shard_tree`, bit for
    bit. Replicated leaves come from tensor rank 0 and, outside the blocks,
    pipe rank 0."""
    pp_size, tp_size = len(shards), len(shards[0])
    hl = cfg.n_heads // tp_size

    def join(name, pieces, spec):
        if name in ("wqkv", "bqkv"):
            heads = [p.reshape(*p.shape[:-1], 3, hl, cfg.head_dim) for p in pieces]
            whole = torch.cat(heads, dim=-2)
            return whole.reshape(*whole.shape[:-3], 3 * cfg.d_model)
        if TENSOR in spec:
            return torch.cat(pieces, dim=spec.index(TENSOR))
        return pieces[0]

    row = shards[0]
    out = {k: join(k, [s[k] for s in row], specs[k])
           for k in row[0] if k != "blocks"}
    out["blocks"] = {
        k: torch.cat([join(k, [s["blocks"][k] for s in stage], specs["blocks"][k])
                      for stage in shards])
        for k in row[0]["blocks"]}
    return out


def _tp_world() -> int:
    """The tensor group's size once model parallelism is initialized, else
    0 (the dense model)."""
    if not parallel_state.model_parallel_is_initialized():
        return 0
    return parallel_state.get_tensor_model_parallel_world_size()


def _seq_first(cfg) -> bool:
    """Whether the residual stream is laid out (S, B, D) and split along S
    over the tensor group."""
    return cfg.sequence_parallel and _tp_world() > 0


def _column_input(h, cfg):
    """A column-parallel GEMM's input: gathered along S under sequence
    parallelism (the backward reduce-scatters), else through the f region
    (the backward all-reduces)."""
    if not _tp_world():
        return h
    if cfg.sequence_parallel:
        return mp.gather_from_sequence_parallel_region(h, TENSOR, True)
    return mp.copy_to_tensor_model_parallel_region(h, TENSOR)


def _row_output(y, cfg):
    """A row-parallel GEMM's partial products summed over the tensor group
    (reduce-scattered along S under sequence parallelism)."""
    if not _tp_world():
        return y
    if cfg.sequence_parallel:
        return mp.reduce_scatter_to_sequence_parallel_region(y, TENSOR)
    return mp.reduce_from_tensor_model_parallel_region(y, TENSOR)


def _row_bias(b):
    """A row-parallel GEMM's bias: whole on tensor rank 0; on the others a
    zero that carries the bias's gradient, so the sum adds it once and every
    rank's gradient of it is whole."""
    if _tp_world() and parallel_state.get_tensor_model_parallel_rank() != 0:
        return b - b.detach()
    return b


def _layernorm(x, scale, bias, cfg):
    """Fused LN (K1/K3); fp32 gamma/beta may meet bf16 activations uncast.
    Under sequence parallelism the parameter gradients are all-reduced over
    the tensor group."""
    return sp_fused_layer_norm(x, scale, bias, sequence_parallel=_seq_first(cfg),
                               impl=cfg.norm_impl)


def _heads(t, n_heads, seq_first=False):
    """(B, S, D) — or (S, B, D) with ``seq_first`` — as (B, H, S, D / H)."""
    if seq_first:
        S, B, D = t.shape
        return t.reshape(S, B, n_heads, D // n_heads).permute(1, 2, 0, 3)
    B, S, D = t.shape
    return t.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _heads_place(n_heads: int, cfg) -> Optional[RankPlace]:
    """This tensor rank's ``n_heads`` heads among the model's, for the
    attention probabilities' masks (None for the dense model)."""
    if not _tp_world():
        return None
    rank = parallel_state.get_tensor_model_parallel_rank()
    return RankPlace(n_heads, cfg.n_heads, rank * n_heads)


def _hidden_dropout(cfg, key, t, rate):
    """Dropout of the residual stream with the one-device ``(B, S, D)``
    mask: under sequence parallelism ``t`` is this rank's ``(S / tp, B,
    D)`` rows, which draw their part of it (K13 at a row place)."""
    if not _seq_first(cfg):
        return dropout(key, t, rate, impl=cfg.dropout_impl)
    rows = t.shape[0]
    place = RankPlace(1, 1, 0, parallel_state.get_tensor_model_parallel_rank() * rows)
    return dropout(key, t.transpose(0, 1), rate, impl=cfg.dropout_impl,
                   place=place).transpose(0, 1)
