"""Megatron-style pretraining batch samplers — counterpart of
``beforeholiday_tpu/transformer/_data/batchsampler.py`` (ref:
apex/transformer/_data/_batchsampler.py:1-180, itself extracted from
Megatron-LM's data_samplers.py). Host-side Python; the shuffle is numpy's
epoch-seeded permutation, so both packages yield the same indices.

Semantics:

* ``MegatronPretrainingSampler`` — sequential, checkpointable via
  ``consumed_samples``: the global sample stream is chopped into global
  minibatches of ``local_minibatch_size * data_parallel_size``; each DP rank
  yields its contiguous slice. (The reference fork fills its buffer only to
  ``local_minibatch_size`` before slicing — a port artifact that starves
  every rank but 0; this implementation fills the full global minibatch, the
  upstream Megatron behavior the class documents.)
* ``MegatronPretrainingRandomSampler`` — epoch-seeded shuffle inside this
  rank's bucket, resumable mid-epoch from ``consumed_samples``
  (ref: :155-180 — bucket_size/bucket_offset arithmetic preserved).

Both yield plain python index lists, one sampler per data-parallel rank.
"""

from __future__ import annotations

import abc

import numpy as np

__all__ = [
    "MegatronPretrainingSampler",
    "MegatronPretrainingRandomSampler",
]


class _Base(abc.ABC):
    """Base class for Megatron-style batch samplers (ref: _batchsampler.py:16)."""

    total_samples: int
    consumed_samples: int
    data_parallel_rank: int
    data_parallel_size: int

    def _validate(self, *, check_consumed: bool):
        if self.total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {self.total_samples}")
        if check_consumed and self.consumed_samples >= self.total_samples:
            raise RuntimeError(
                f"no samples left to consume: {self.consumed_samples}, "
                f"{self.total_samples}"
            )
        if self._local_minibatch_size <= 0:
            raise RuntimeError(
                f"local minibatch size must be greater than 0: "
                f"{self._local_minibatch_size}"
            )
        if self.data_parallel_size <= 0:
            raise RuntimeError(
                f"data parallel size must be greater than 0: {self.data_parallel_size}"
            )
        if self.data_parallel_rank >= self.data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank should be smaller than data size: "
                f"{self.data_parallel_rank}, {self.data_parallel_size}"
            )

    def __len__(self) -> int:
        return self.total_samples

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_size: int) -> None:
        # dynamic batch-size / rampup support: resized mid-training
        self._local_minibatch_size = new_size
        self.local_minibatch_times_data_parallel_size = (
            new_size * self.data_parallel_size
        )

    @abc.abstractmethod
    def __iter__(self):
        ...


class MegatronPretrainingSampler(_Base):
    """Sequential, resumable pretraining sampler (ref: _batchsampler.py:38)."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size
        )
        self.drop_last = drop_last
        self._validate(check_consumed=True)

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.local_minibatch_times_data_parallel_size:
                start, end = self.get_start_end_idx()
                yield batch[start:end]
                batch = []
        # partial final global batch: each rank takes its (possibly short or
        # empty) slice unless drop_last
        if batch and not self.drop_last:
            start, end = self.get_start_end_idx()
            yield batch[start:end]


class MegatronPretrainingRandomSampler(_Base):
    """Epoch-seeded shuffled sampler, resumable mid-epoch
    (ref: _batchsampler.py:100)."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size
        )
        self._validate(check_consumed=False)
        if self.total_samples < self.local_minibatch_times_data_parallel_size:
            raise RuntimeError(
                f"total_samples ({total_samples}) smaller than one global "
                f"minibatch ({self.local_minibatch_times_data_parallel_size})"
            )
        self.last_batch_size = (
            self.total_samples % self.local_minibatch_times_data_parallel_size
        )

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples

        # this rank's contiguous bucket of the dataset; shuffle is epoch-seeded
        # so every rank/restart derives the same permutation
        bucket_size = (
            self.total_samples // self.local_minibatch_times_data_parallel_size
        ) * self.local_minibatch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        rng = np.random.RandomState(self.epoch)
        random_idx = rng.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        # last partial local minibatch is dropped (ref convention)
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += self.local_minibatch_times_data_parallel_size
                yield batch
                batch = []
