"""Tensor and sequence parallelism (ref: apex/transformer/tensor_parallel/):
the collective mappings, the parallel layers, the vocab-parallel cross
entropy, the data broadcast, the memory buffers, and the RNG discipline
(dropout keys, dropout and activation checkpointing, ``random``), and the
collective matmul (``collective``)."""

from beforeholiday_tpu_torch.transformer.tensor_parallel import collective  # noqa: F401
from beforeholiday_tpu_torch.transformer.tensor_parallel.collective import (  # noqa: F401
    all_gather_matmul,
    collective_matmul_enabled,
    set_collective_matmul,
)

from beforeholiday_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.data import broadcast_data  # noqa: F401
from beforeholiday_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
    vocab_range,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    collective_chunk_bytes,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    set_collective_chunk_bytes,
)
from beforeholiday_tpu_torch.transformer.tensor_parallel.memory import (  # noqa: F401
    MemoryBuffer,
    RingMemBuffer,
)
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

__all__ = [
    "MemoryBuffer", "RingMemBuffer", "all_gather_matmul", "broadcast_data",
    "checkpoint", "checkpoint_apply", "collective", "collective_chunk_bytes",
    "collective_matmul_enabled", "column_parallel_linear",
    "copy_to_tensor_model_parallel_region", "data_parallel_seed", "dropout",
    "fold_in", "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region", "make_key",
    "model_parallel_seed", "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region", "row_parallel_linear",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region", "set_collective_chunk_bytes",
    "set_collective_matmul",
    "split", "vocab_parallel_cross_entropy", "vocab_parallel_embedding",
    "vocab_range",
]
