"""vLLM-style scheduler (ref: sarathi-lean/sarathi/core/scheduler/vllm_scheduler.py:20+).

Whole-prompt prefill (no chunking): admit waiting sequences up to the
batched-token budget, then batch all running decodes with preemption.
"""

from __future__ import annotations

import time
from typing import List

from vattention_tpu_torch.config import CacheConfig, VllmSchedulerConfig
from vattention_tpu_torch.core.block_space_manager.vattention_block_space_manager import (
    vAttentionBlockSpaceManager,
)
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import (
    Sequence, SequenceScheduleMetadata)
from vattention_tpu_torch.core.scheduler.base_scheduler import BaseScheduler


class VLLMScheduler(BaseScheduler):
    def __init__(self, scheduler_config: VllmSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        super().__init__(scheduler_config, cache_config)
        self.max_num_batched_tokens = (
            scheduler_config.get_max_num_batched_tokens(
                scheduler_config.max_model_len))
        self.prompt_limit = scheduler_config.max_model_len

    def _schedule(self) -> SchedulerOutputs:
        now = time.monotonic()
        ignored_seq_ids: List[str] = []
        preempted_seq_ids: List[str] = []
        scheduled: List[SequenceScheduleMetadata] = []
        if isinstance(self.block_manager, vAttentionBlockSpaceManager):
            self.block_manager.clear_promised_blocks()

        # Prefill phase: admit whole prompts while they fit, up to the
        # per-step run budget (ref batches many prompts per iteration,
        # vllm_scheduler.py:20+; the TPU step fuses the K padded chunks
        # into one prefill-attention launch, flash_prefill_multi)
        num_batched_tokens = 0
        max_prefills = self.scheduler_config.max_prefills_per_step
        while self.waiting and len(scheduled) < max_prefills:
            seq = self.waiting[0]
            if seq.arrival_time > now:
                break
            if not self._check_request_prompt_length(seq):
                ignored_seq_ids.append(seq.seq_id)
                continue
            num_prompt_tokens = seq.get_len()
            if num_prompt_tokens + num_batched_tokens > \
                    self.max_num_batched_tokens:
                break
            if not self.block_manager.can_allocate(seq):
                break
            if len(self.running) + 1 > self.scheduler_config.max_num_seqs:
                break
            seq = self.waiting.pop(0)
            self._allocate(seq)
            num_batched_tokens += num_prompt_tokens
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=num_prompt_tokens))
            self.running.append(seq)

        if scheduled:
            return SchedulerOutputs(self._iteration_id, ignored_seq_ids,
                                    preempted_seq_ids, scheduled)

        # Decode phase with preemption (ref vllm_scheduler decode pass)
        self.running = self.policy.sort_by_priority(now, self.running)
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
