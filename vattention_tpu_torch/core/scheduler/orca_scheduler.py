"""Orca scheduler (ref: sarathi-lean orca_scheduler.py, 80 LoC).

Iteration-level scheduling with whole-prompt prefills; admission bounded
only by max_num_seqs (memory reserved for max_model_len per seq by the
Orca block manager).
"""

from __future__ import annotations

import time
from typing import List

from vattention_tpu_torch.config import CacheConfig, OrcaSchedulerConfig
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import SequenceScheduleMetadata
from vattention_tpu_torch.core.scheduler.base_scheduler import BaseScheduler


class OrcaScheduler(BaseScheduler):
    def __init__(self, scheduler_config: OrcaSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        super().__init__(scheduler_config, cache_config)

    def _schedule(self) -> SchedulerOutputs:
        now = time.monotonic()
        ignored_seq_ids: List[str] = []
        scheduled: List[SequenceScheduleMetadata] = []

        # admit one new prompt per step (single prefill region)
        while (self.waiting
               and len(self.running) < self.scheduler_config.max_num_seqs):
            seq = self.waiting[0]
            if seq.arrival_time > now:
                break
            if not self._check_request_prompt_length(seq):
                ignored_seq_ids.append(seq.seq_id)
                continue
            if not self.block_manager.can_allocate(seq):
                break
            seq = self.waiting.pop(0)
            self._allocate(seq)
            self.running.append(seq)
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=seq.get_prompt_len()))
            break

        for seq in self.running:
            if seq.is_paused() and seq.prompt_processing_finished:
                scheduled.append(SequenceScheduleMetadata.from_sequence(seq))

        return SchedulerOutputs(self._iteration_id, ignored_seq_ids, [],
                                scheduled)
