"""Cache engine ABC (ref: sarathi-lean base_cache_engine.py:18-64)."""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import List, Optional, Tuple

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import SequenceMetadata

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arena_dtype(config: SystemConfig) -> Tuple[torch.dtype, Optional[float]]:
    """The KV storage dtype and int8 step of a configuration, as the JAX
    cache engines choose them: the model's dtype, e4m3 for
    ``kv_quant="fp8"``, or int8 for ``kv_quant="int8"`` with the step
    ``KV_INT8_SCALE`` (default 0.04) from the environment."""
    quant = config.cache_config.kv_quant
    if quant == "fp8":
        return torch.float8_e4m3fn, None
    if quant == "int8":
        return torch.int8, float(os.environ.get("KV_INT8_SCALE", "0.04"))
    return DTYPES[config.model_config.dtype], None


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
