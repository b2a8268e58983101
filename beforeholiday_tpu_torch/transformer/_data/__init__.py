"""Megatron pretraining batch samplers (ref: apex/transformer/_data/)."""

from beforeholiday_tpu_torch.transformer._data.batchsampler import (  # noqa: F401
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)

__all__ = ["MegatronPretrainingRandomSampler", "MegatronPretrainingSampler"]
