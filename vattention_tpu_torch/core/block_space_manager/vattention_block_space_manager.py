"""vAttention block-space manager (scheduler-side admission control).

ref: sarathi-lean/sarathi/core/block_space_manager/vattention_block_space_manager.py:9-97.
Tracks the worker-reported free-KV-block count plus ``promised_blocks``
optimism for same-iteration admissions; the real allocation happens in
the worker's cache engine each step.  The promises of each schedule start
from the prompt blocks that admitted requests have yet to map
(``clear_promised_blocks``), where the JAX package starts from 0.
"""

from __future__ import annotations

import math
from typing import Dict, List

from vattention_tpu_torch.core.datatypes.sequence import Sequence


class vAttentionBlockSpaceManager:
    def __init__(self, block_size: int, num_gpu_blocks: int,
                 max_model_len: int, watermark: float = 0.01) -> None:
        self.block_size = block_size
        self.num_total_gpu_blocks = num_gpu_blocks
        self.max_model_len = max_model_len
        self.promised_blocks = 0
        self.watermark = watermark
        assert watermark >= 0.0
        self.watermark_blocks = int(watermark * num_gpu_blocks)
        self.active_requests: Dict[str, Sequence] = {}
        self.preemption_queue: List[Sequence] = []
        self.free_blocks = num_gpu_blocks

    def get_num_blocks(self, seq: Sequence) -> int:
        return math.ceil(seq.get_len() / self.block_size)

    def can_allocate(self, seq: Sequence) -> bool:
        num_required = self.get_num_blocks(seq)
        return (self.free_blocks - self.promised_blocks - num_required
                >= self.watermark_blocks)

    def set_free_blocks(self, free_blocks: int) -> None:
        """Pushed from the worker's allocator every engine step
        (ref base_llm_engine.py:381-390)."""
        self.free_blocks = free_blocks

    def allocate(self, seq: Sequence) -> None:
        self.active_requests[seq.seq_id] = seq
        self.promised_blocks += self.get_num_blocks(seq)

    def can_append_slot(self) -> bool:
        return self.free_blocks - self.promised_blocks > 0

    def append_slot(self, seq: Sequence) -> None:
        len_seq = seq.get_len()
        cur = math.ceil(len_seq / self.block_size)
        new = math.ceil((len_seq + 1) / self.block_size)
        if new > cur:
            self.promised_blocks += 1

    def free(self, seq: Sequence) -> None:
        if seq.seq_id not in self.active_requests:
            return
        del self.active_requests[seq.seq_id]
        self.free_blocks += self.get_num_blocks(seq)

    def reset(self) -> None:
        self.active_requests = {}

    def clear_promised_blocks(self) -> None:
        """A schedule's promises start from the blocks that admitted
        requests still need for the rest of their prompts: the allocator
        maps a prompt chunk by chunk, so its free count does not hold them.
        (The JAX package starts from 0, so under memory pressure it admits
        and grows past the arena and its allocator aborts.)"""
        self.promised_blocks = sum(
            self._unmapped_prompt_blocks(seq)
            for seq in self.active_requests.values())

    def _unmapped_prompt_blocks(self, seq: Sequence) -> int:
        if seq.prompt_processing_finished:
            return 0
        return (math.ceil(seq.get_prompt_len() / self.block_size)
                - math.ceil(seq.get_num_prompt_tokens_processed()
                            / self.block_size))

    def is_allocated(self, seq: Sequence) -> bool:
        return seq.seq_id in self.active_requests

    def get_num_free_gpu_blocks(self) -> int:
        return self.free_blocks
