"""Microbatch calculators — counterpart of
``beforeholiday_tpu/transformer/pipeline_parallel/microbatches.py`` (ref:
apex/transformer/microbatches.py:26-195), pure Python.

Constant and ramp-up global-batch → num-microbatches calculators, ported
structurally: the ramp-up variant increases the effective global batch linearly
with consumed samples, exactly as Megatron's curriculum.
"""

from __future__ import annotations

from typing import Optional


def build_num_microbatches_calculator(
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[list] = None,
):
    """Factory (ref: microbatches.py:26-66 ``build_num_microbatches_calculator``)."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size must be [start_size, increment, ramp_samples]"
        )
    start, incr, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, incr, samples, global_batch_size, micro_batch_size, data_parallel_size
    )


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches = None
        self.current_global_batch_size = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Ref: microbatches.py:69-83."""

    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        micro_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel size "
                f"({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("global batch size must be at least micro batch "
                             "size times data parallel size")
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear global-batch ramp-up (ref: microbatches.py:86-195)."""

    def __init__(
        self,
        start_batch_size,
        batch_size_increment,
        ramup_samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    ):
        super().__init__()
        assert global_batch_size > 0 and start_batch_size > 0
        assert batch_size_increment > 0
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        assert start_batch_size % self.micro_batch_times_data_parallel_size == 0
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        diff = global_batch_size - start_batch_size
        assert diff >= 0 and diff % batch_size_increment == 0, (
            "global batch must be reachable from start by integer increments"
        )
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0 else 0
        )
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples or self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size
            )
        if consistency_check:
            assert (
                self.current_global_batch_size
                % self.micro_batch_times_data_parallel_size
                == 0
            )
        self.num_micro_batches = (
            self.current_global_batch_size // self.micro_batch_times_data_parallel_size
        )
