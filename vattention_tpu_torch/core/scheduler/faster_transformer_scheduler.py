"""FasterTransformer-style scheduler (ref: sarathi-lean
faster_transformer_scheduler.py, 89 LoC): static batching -- admit a
batch, run it to completion, then admit the next batch.
"""

from __future__ import annotations

import time
from typing import List

from vattention_tpu_torch.config import CacheConfig, FasterTransformerSchedulerConfig
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import SequenceScheduleMetadata
from vattention_tpu_torch.core.scheduler.base_scheduler import BaseScheduler


class FasterTransformerScheduler(BaseScheduler):
    def __init__(self, scheduler_config: FasterTransformerSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        super().__init__(scheduler_config, cache_config)

    def _schedule(self) -> SchedulerOutputs:
        now = time.monotonic()
        ignored_seq_ids: List[str] = []
        scheduled: List[SequenceScheduleMetadata] = []

        # no admissions while the current batch is in flight
        if not self.running:
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
                break  # one prefill per step

        for seq in self.running:
            if not seq.is_paused():
                continue
            if not seq.prompt_processing_finished:
                scheduled.append(SequenceScheduleMetadata.from_sequence(
                    seq, prompt_chunk_len=seq.get_prompt_len()
                    - seq.get_num_prompt_tokens_processed()))
            else:
                scheduled.append(SequenceScheduleMetadata.from_sequence(seq))

        return SchedulerOutputs(self._iteration_id, ignored_seq_ids, [],
                                scheduled)
