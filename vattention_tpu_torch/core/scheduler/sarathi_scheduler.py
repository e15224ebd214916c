"""Sarathi chunked-prefill scheduler.

ref: sarathi-lean/sarathi/core/scheduler/sarathi_scheduler.py:22-284.
Decode-first admission with preemption, then running prefills, then
waiting-queue admission gated by can_allocate and the per-batch chunk
budget.  One prefill per batch (``enable_rolling_prefills`` is False in
the reference, :41) -- which also matches the TPU step layout (a single
padded prefill chunk region per compiled step).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from vattention_tpu_torch.config import (PREFILL_TOKEN_PAD, CacheConfig,
                                   SarathiSchedulerConfig)
from vattention_tpu_torch.core.block_space_manager.vattention_block_space_manager import (
    vAttentionBlockSpaceManager,
)
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import (
    Sequence, SequenceScheduleMetadata)
from vattention_tpu_torch.core.scheduler.base_scheduler import BaseScheduler
from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


class SarathiScheduler(BaseScheduler):
    def __init__(self, scheduler_config: SarathiSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        super().__init__(scheduler_config, cache_config)
        self.prompt_limit = scheduler_config.max_model_len
        self.chunk_size = scheduler_config.chunk_size
        self.enable_dynamic_chunking_schedule = (
            scheduler_config.enable_dynamic_chunking_schedule)
        self.low_chunk_size = scheduler_config.low_chunk_size
        self.high_chunk_size = scheduler_config.high_chunk_size
        self.chunk_schedule_max_tokens = (
            scheduler_config.chunk_schedule_max_tokens)
        self.chunk_schedule_stages = scheduler_config.chunk_schedule_stages
        self.enable_rolling_prefills = (
            scheduler_config.enable_rolling_prefills)
        self.max_prefills_per_step = scheduler_config.max_prefills_per_step

        if self.enable_dynamic_chunking_schedule:
            assert self.chunk_schedule_stages > 0
            assert self.chunk_schedule_max_tokens > 0
            assert self.low_chunk_size % 32 == 0
            assert self.high_chunk_size % 32 == 0
            self._chunk_sizes = self._compute_chunk_size_schedule()
            self._tokens_per_stage = int(np.ceil(
                self.chunk_schedule_max_tokens / self.chunk_schedule_stages))

    def _compute_chunk_size_schedule(self):
        """Decreasing chunk sizes as the context grows (ref :53-68)."""
        chunk_sizes = np.linspace(
            self.low_chunk_size, self.high_chunk_size,
            self.chunk_schedule_stages, dtype=np.int32)[::-1]
        round_of = min(32, self.low_chunk_size)
        chunk_sizes = np.round(chunk_sizes / round_of) * round_of
        return chunk_sizes.astype(np.int64).tolist()

    def _get_seq_next_num_prefill_tokens(
            self, seq: Sequence, batch_contains_prefill: bool,
            prefill_padded_tokens: int) -> int:
        """Prefill token budgeting at the compiled step's granularity.

        The budget is charged in PREFILL_TOKEN_PAD units (the q-tile
        each run is padded to), so the padded runs of one step always
        fit the model runner's fixed-width prefill region -- every mixed
        step then shares ONE jit signature.  Decode tokens do NOT eat
        prefill budget: the compiled step gives decodes their own B
        rows, so its compute is n_pre + B regardless (this diverges from
        the reference's shared counter, sarathi_scheduler.py:54-69,
        because the reference's step cost is proportional to scheduled
        tokens while ours is fixed-shape).
        """
        assert not seq.is_finished()
        if self.enable_dynamic_chunking_schedule:
            stage_idx = int(np.ceil(
                seq.get_num_prompt_tokens_processed()
                // self._tokens_per_stage))
            stage_idx = min(stage_idx, len(self._chunk_sizes) - 1)
            chunk_size = self._chunk_sizes[stage_idx]
        else:
            chunk_size = self.chunk_size
        if batch_contains_prefill and not self.enable_rolling_prefills:
            return 0  # one prefill per batch
        pad = PREFILL_TOKEN_PAD
        budget = -(-chunk_size // pad) * pad
        avail = budget - prefill_padded_tokens
        if avail <= 0:
            return 0
        rem = (seq.get_prompt_len()
               - seq.get_num_prompt_tokens_processed())
        if -(-rem // pad) * pad <= avail:
            return rem  # final partial tile fits padded
        return min(rem, (avail // pad) * pad)

    def _schedule(self) -> SchedulerOutputs:
        now = time.monotonic()

        running: List[Sequence] = []
        ignored_seq_ids: List[str] = []
        preempted_seq_ids: List[str] = []
        scheduled: List[SequenceScheduleMetadata] = []

        num_batched_tokens = 0
        prefill_padded = 0  # prefill budget used, in PAD units
        batch_contains_prefill = False
        if isinstance(self.block_manager, vAttentionBlockSpaceManager):
            self.block_manager.clear_promised_blocks()

        # Phase 1a: decodes first (accurate decode-token accounting with
        # preemption, ref :141-183)
        self.running = self.policy.sort_by_priority(now, self.running)
        running_prefills: List[Sequence] = []

        while self.running:
            seq = self.running.pop(0)
            if not seq.is_paused():
                running.append(seq)
                continue
            if not seq.prompt_processing_finished:
                running_prefills.append(seq)
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
                num_batched_tokens += 1
                scheduled.append(SequenceScheduleMetadata.from_sequence(seq))

        # Phase 1b: running prefills (memory already allocated, ref :188-211)
        num_prefills = 0
        for seq in running_prefills:
            assert not seq.prompt_processing_finished
            if num_prefills >= self.max_prefills_per_step:
                running.append(seq)
                continue
            next_num = self._get_seq_next_num_prefill_tokens(
                seq, batch_contains_prefill, prefill_padded)
            if next_num == 0:
                running.append(seq)
                continue
            batch_contains_prefill = True
            num_prefills += 1
            num_batched_tokens += next_num
            prefill_padded += (-(-next_num // PREFILL_TOKEN_PAD)
                               * PREFILL_TOKEN_PAD)
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=next_num))
            running.append(seq)

        # Phase 2: admit waiting sequences (ref :216-273)
        while self.waiting:
            seq = self.waiting[0]
            if seq.arrival_time > now:
                break
            if not self._check_request_prompt_length(seq):
                ignored_seq_ids.append(seq.seq_id)
                continue
            if not self.block_manager.can_allocate(seq):
                break
            if len(running) >= self.scheduler_config.max_num_seqs:
                break
            if num_prefills >= self.max_prefills_per_step:
                break
            next_num = self._get_seq_next_num_prefill_tokens(
                seq, batch_contains_prefill, prefill_padded)
            if next_num == 0:
                break
            seq = self.waiting.pop(0)
            self._allocate(seq)
            batch_contains_prefill = True
            num_prefills += 1
            num_batched_tokens += next_num
            prefill_padded += (-(-next_num // PREFILL_TOKEN_PAD)
                               * PREFILL_TOKEN_PAD)
            scheduled.append(SequenceScheduleMetadata.from_sequence(
                seq, prompt_chunk_len=next_num))
            running.append(seq)

        self.running = running
        return SchedulerOutputs(
            id=self._iteration_id,
            ignored_seq_ids=ignored_seq_ids,
            preempted_seq_ids=preempted_seq_ids,
            scheduled_seq_metadata_list=scheduled,
        )
