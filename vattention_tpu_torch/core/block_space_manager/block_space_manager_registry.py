"""Registry mapping scheduler type -> block-space manager class.

ref: sarathi-lean/sarathi/core/block_space_manager/block_space_manager_registry.py
plus the thin per-scheduler subclasses (vllm/sarathi/orca/ft/
simple_chunking, 7-17 LoC each in the reference).
"""

from __future__ import annotations

import math

from vattention_tpu_torch.config import SchedulerType
from vattention_tpu_torch.core.block_space_manager.base_block_space_manager import (
    BaseBlockSpaceManager,
)
from vattention_tpu_torch.core.datatypes.sequence import Sequence


class VLLMBlockSpaceManager(BaseBlockSpaceManager):
    def get_num_initial_blocks(self, seq: Sequence) -> int:
        return math.ceil(seq.get_len() / self.block_size)


class SarathiBlockSpaceManager(BaseBlockSpaceManager):
    def get_num_initial_blocks(self, seq: Sequence) -> int:
        return math.ceil(seq.get_len() / self.block_size)


class SimpleChunkingBlockSpaceManager(BaseBlockSpaceManager):
    def get_num_initial_blocks(self, seq: Sequence) -> int:
        return math.ceil(seq.get_len() / self.block_size)


class OrcaBlockSpaceManager(BaseBlockSpaceManager):
    def get_num_initial_blocks(self, seq: Sequence) -> int:
        return math.ceil(self.max_model_len / self.block_size)


class FasterTransformerBlockSpaceManager(BaseBlockSpaceManager):
    def get_num_initial_blocks(self, seq: Sequence) -> int:
        return math.ceil(self.max_model_len / self.block_size)


class BlockSpaceManagerRegistry:
    _REGISTRY = {
        SchedulerType.VLLM: VLLMBlockSpaceManager,
        SchedulerType.SARATHI: SarathiBlockSpaceManager,
        SchedulerType.SIMPLE_CHUNKING: SimpleChunkingBlockSpaceManager,
        SchedulerType.ORCA: OrcaBlockSpaceManager,
        SchedulerType.FASTER_TRANSFORMER: FasterTransformerBlockSpaceManager,
    }

    @classmethod
    def get(cls, scheduler_type: SchedulerType, block_size: int,
            num_gpu_blocks: int, max_model_len: int):
        return cls._REGISTRY[scheduler_type](
            block_size, num_gpu_blocks, max_model_len)
