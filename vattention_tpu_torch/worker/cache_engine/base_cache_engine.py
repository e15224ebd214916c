"""Cache engine ABC (ref: sarathi-lean base_cache_engine.py:18-64)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import SequenceMetadata


class BaseCacheEngine(ABC):
    """Owns the device KV storage and per-iteration physical allocation."""

    def __init__(self, config: SystemConfig):
        self.config = config

    @abstractmethod
    def step(self, seq_metadata_list: List[SequenceMetadata]) -> None:
        """Guarantee device memory for this iteration's tokens."""

    @abstractmethod
    def on_step_completion(
            self, seq_metadata_list: List[SequenceMetadata]) -> None:
        """Release resources of finished sequences."""

    @abstractmethod
    def get_free_blocks(self) -> int:
        ...

    @abstractmethod
    def cleanup(self) -> None:
        ...
