"""Microbatch calculators — port of ``apex_tpu/transformer/microbatches.py``
(apex ``apex/transformer/microbatches.py``).

Framework-free: the same three classes and factory as the JAX module, a
constant calculator and a batch-size-rampup calculator, built by
``build_num_microbatches_calculator``.
"""

from __future__ import annotations

from typing import Optional


def build_num_microbatches_calculator(rank, rampup_batch_size,
                                      global_batch_size, micro_batch_size,
                                      data_parallel_size):
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(global_batch_size, micro_batch_size,
                                       data_parallel_size)
    if len(rampup_batch_size) != 3:
        raise ValueError("expected the following format: --rampup-batch-size"
                         " <start batch size> <batch size increment> "
                         "<ramp-up samples>")
    start, incr, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, incr, samples, global_batch_size, micro_batch_size,
        data_parallel_size)


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self):
        return self.num_micro_batches

    def get_current_global_batch_size(self):
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size, micro_batch_size,
                 data_parallel_size):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible "
                f"by micro batch size ({micro_batch_size}) times data "
                f"parallel size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("number of micro-batches is less than 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, start_batch_size, batch_size_increment, ramup_samples,
                 global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_times_data_parallel_size = \
            micro_batch_size * data_parallel_size
        if global_batch_size % self.micro_batch_times_data_parallel_size:
            raise ValueError("global batch size not divisible by micro "
                             "batch size times data parallel size")
        if batch_size_increment <= 0:
            raise ValueError(
                f"batch size increment ({batch_size_increment}) must be "
                "positive")
        diff = global_batch_size - start_batch_size
        if diff < 0 or diff % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff}) to be "
                f"divisible by global batch size increment "
                f"({batch_size_increment})")
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments else 0)
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples or \
                self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples //
                        self.rampup_samples_per_increment)
            self.current_global_batch_size = min(
                self.start_batch_size
                + steps * self.batch_size_increment,
                self.global_batch_size)
        if self.current_global_batch_size % \
                self.micro_batch_times_data_parallel_size != 0:
            # apex asserts here: the ramp configuration must keep every
            # intermediate batch size a multiple of micro*dp
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                f"micro-batch-size ({self.micro_batch_size}) times "
                f"data parallel size ({self.data_parallel_size})")
        self.num_micro_batches = (
            self.current_global_batch_size //
            self.micro_batch_times_data_parallel_size)
