"""Simple-chunking scheduler (ref: sarathi-lean simple_chunking_scheduler.py, 199 LoC).

Chunked prefill like Sarathi but WITHOUT decode-maximal batching: a step
is either a prefill chunk or a decode batch, never mixed.
"""

from __future__ import annotations

import time
from typing import List

from vattention_tpu_torch.config import CacheConfig, SimpleChunkingSchedulerConfig
from vattention_tpu_torch.core.block_space_manager.vattention_block_space_manager import (
    vAttentionBlockSpaceManager,
)
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import (
    Sequence, SequenceScheduleMetadata)
from vattention_tpu_torch.core.scheduler.base_scheduler import BaseScheduler


class SimpleChunkingScheduler(BaseScheduler):
    def __init__(self, scheduler_config: SimpleChunkingSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        super().__init__(scheduler_config, cache_config)
        self.chunk_size = scheduler_config.chunk_size

    def _schedule(self) -> SchedulerOutputs:
        now = time.monotonic()
        ignored_seq_ids: List[str] = []
        preempted_seq_ids: List[str] = []
        scheduled: List[SequenceScheduleMetadata] = []
        if isinstance(self.block_manager, vAttentionBlockSpaceManager):
            self.block_manager.clear_promised_blocks()

        self.running = self.policy.sort_by_priority(now, self.running)

        # prefill-only step when any prompt is incomplete
        for seq in list(self.running):
            if not seq.is_paused() or seq.prompt_processing_finished:
                continue
            next_num = min(
                seq.get_prompt_len() - seq.get_num_prompt_tokens_processed(),
                self.chunk_size)
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=next_num))
            return SchedulerOutputs(self._iteration_id, ignored_seq_ids,
                                    preempted_seq_ids, scheduled)

        # admit one waiting sequence as a fresh prefill
        while self.waiting:
            seq = self.waiting[0]
            if seq.arrival_time > now:
                break
            if not self._check_request_prompt_length(seq):
                ignored_seq_ids.append(seq.seq_id)
                continue
            if not self.block_manager.can_allocate(seq):
                break
            if len(self.running) >= self.scheduler_config.max_num_seqs:
                break
            seq = self.waiting.pop(0)
            self._allocate(seq)
            next_num = min(seq.get_prompt_len(), self.chunk_size)
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=next_num))
            self.running.append(seq)
            return SchedulerOutputs(self._iteration_id, ignored_seq_ids,
                                    preempted_seq_ids, scheduled)

        # decode-only step
        running: List[Sequence] = []
        while self.running:
            seq = self.running.pop(0)
            if not seq.is_paused():
                running.append(seq)
                continue
            while not self.block_manager.can_append_slot():
                if self.running:
                    victim = self.running.pop(-1)
                    self._preempt(victim)
                    preempted_seq_ids.append(victim.seq_id)
                else:
                    self._preempt(seq)
                    preempted_seq_ids.append(seq.seq_id)
                    break
            else:
                self._append_slot(seq)
                running.append(seq)
                scheduled.append(SequenceScheduleMetadata.from_sequence(seq))
        self.running = running
        return SchedulerOutputs(self._iteration_id, ignored_seq_ids,
                                preempted_seq_ids, scheduled)
