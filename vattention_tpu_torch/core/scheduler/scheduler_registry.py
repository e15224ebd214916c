"""Scheduler registry (ref: sarathi-lean scheduler_registry.py:23)."""

from __future__ import annotations

from vattention_tpu_torch.config import SchedulerType
from vattention_tpu_torch.core.scheduler.faster_transformer_scheduler import (
    FasterTransformerScheduler,
)
from vattention_tpu_torch.core.scheduler.orca_scheduler import OrcaScheduler
from vattention_tpu_torch.core.scheduler.sarathi_scheduler import SarathiScheduler
from vattention_tpu_torch.core.scheduler.simple_chunking_scheduler import (
    SimpleChunkingScheduler,
)
from vattention_tpu_torch.core.scheduler.vllm_scheduler import VLLMScheduler


class SchedulerRegistry:
    _REGISTRY = {
        SchedulerType.SARATHI: SarathiScheduler,
        SchedulerType.VLLM: VLLMScheduler,
        SchedulerType.SIMPLE_CHUNKING: SimpleChunkingScheduler,
        SchedulerType.ORCA: OrcaScheduler,
        SchedulerType.FASTER_TRANSFORMER: FasterTransformerScheduler,
    }

    @classmethod
    def get(cls, scheduler_type: SchedulerType, scheduler_config,
            cache_config):
        return cls._REGISTRY[scheduler_type](scheduler_config, cache_config)
