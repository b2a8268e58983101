"""Tensor parallelism's RNG discipline — the part of
``beforeholiday_tpu/transformer/tensor_parallel`` that one device needs:
dropout keys, dropout and activation checkpointing (``random``). The
parallel layers, mappings and collectives are not ported yet."""

from beforeholiday_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    checkpoint,
    checkpoint_apply,
    data_parallel_seed,
    dropout,
    fold_in,
    make_key,
    model_parallel_seed,
    split,
)

__all__ = ["checkpoint", "checkpoint_apply", "data_parallel_seed", "dropout",
           "fold_in", "make_key", "model_parallel_seed", "split"]
