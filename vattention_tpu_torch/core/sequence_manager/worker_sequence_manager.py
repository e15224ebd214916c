"""Worker-side sequence manager (ref: worker_sequence_manager.py:15-70).

Owns a worker-local block manager mirror and frees finished sequences.
"""

from __future__ import annotations

from vattention_tpu_torch.config import CacheConfig, BaseSchedulerConfig
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.sequence_manager.base_sequence_manager import (
    BaseSequenceManager,
)


class WorkerSequenceManager(BaseSequenceManager):
    def __init__(self, cache_config: CacheConfig,
                 scheduler_config: BaseSchedulerConfig):
        super().__init__()
        self.cache_config = cache_config
        self.scheduler_config = scheduler_config

    def _free_seq(self, seq_id: str) -> None:
        super()._free_seq(seq_id)

    def on_step_completed(self, scheduler_outputs: SchedulerOutputs,
                          sampler_outputs) -> None:
        super().on_step_completed(scheduler_outputs, sampler_outputs)
        # drop finished sequences from the map (the cache engine frees
        # their batch slots on its own on_step_completion)
        for meta in scheduler_outputs.scheduled_seq_metadata_list:
            seq = self.seq_map.get(meta.seq_id)
            if seq is not None and seq.is_finished():
                self._free_seq(meta.seq_id)
