"""Scheduler-side block accounting for paged backends.

ref: sarathi-lean/sarathi/core/block_space_manager/base_block_space_manager.py
(BlockAllocator + per-seq block tables; admission control only -- the
physical pool lives in the cache engine).
"""

from __future__ import annotations

import math
from typing import Dict, List

from vattention_tpu_torch.core.datatypes.sequence import Sequence


class BlockAllocator:
    """Free-list allocator over numbered blocks (ref :BlockAllocator)."""

    def __init__(self, block_size: int, num_blocks: int) -> None:
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.free_blocks: List[int] = list(range(num_blocks))

    def allocate(self) -> int:
        if not self.free_blocks:
            raise ValueError("Out of memory! No free blocks are available.")
        return self.free_blocks.pop()

    def free(self, block: int) -> None:
        self.free_blocks.append(block)

    def get_num_free_blocks(self) -> int:
        return len(self.free_blocks)


class BaseBlockSpaceManager:
    """ref: base_block_space_manager.py (watermark admission + tables)."""

    def __init__(self, block_size: int, num_gpu_blocks: int,
                 max_model_len: int, watermark: float = 0.01) -> None:
        self.block_size = block_size
        self.num_total_gpu_blocks = num_gpu_blocks
        self.max_model_len = max_model_len
        self.watermark = watermark
        assert watermark >= 0.0
        self.watermark_blocks = int(watermark * num_gpu_blocks)
        self.gpu_allocator = BlockAllocator(block_size, num_gpu_blocks)
        self.block_tables: Dict[str, List[int]] = {}

    def get_num_initial_blocks(self, seq: Sequence) -> int:
        raise NotImplementedError

    def can_allocate(self, seq: Sequence) -> bool:
        num_required = self.get_num_initial_blocks(seq)
        num_free = self.gpu_allocator.get_num_free_blocks()
        return num_free - num_required >= self.watermark_blocks

    def allocate(self, seq: Sequence) -> None:
        num_initial = self.get_num_initial_blocks(seq)
        self.block_tables[seq.seq_id] = [
            self.gpu_allocator.allocate() for _ in range(num_initial)]

    def can_append_slot(self) -> bool:
        return self.gpu_allocator.get_num_free_blocks() > 0

    def append_slot(self, seq: Sequence) -> None:
        table = self.block_tables[seq.seq_id]
        num_logical = math.ceil((seq.get_len() + 1) / self.block_size)
        if len(table) < num_logical:
            table.append(self.gpu_allocator.allocate())

    def free(self, seq: Sequence) -> None:
        if seq.seq_id not in self.block_tables:
            return
        for block in set(self.block_tables.pop(seq.seq_id)):
            self.gpu_allocator.free(block)

    def reset(self) -> None:
        for seq_id in list(self.block_tables):
            for block in set(self.block_tables.pop(seq_id)):
                self.gpu_allocator.free(block)

    def get_block_table(self, seq: Sequence) -> List[int]:
        return list(self.block_tables[seq.seq_id])

    def get_num_free_gpu_blocks(self) -> int:
        return self.gpu_allocator.get_num_free_blocks()

    def is_allocated(self, seq: Sequence) -> bool:
        return seq.seq_id in self.block_tables
