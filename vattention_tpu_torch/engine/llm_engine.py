"""LLMEngine facade (counterpart of vattention_tpu/engine/llm_engine.py)."""

from __future__ import annotations

from vattention_tpu_torch.engine.arg_utils import EngineArgs
from vattention_tpu_torch.engine.base_llm_engine import BaseLLMEngine


class LLMEngine:
    @classmethod
    def from_engine_args(cls, **kwargs) -> BaseLLMEngine:
        """Build an engine from EngineArgs fields; it runs on the GPU
        unless ``device="cpu"`` is passed."""
        return cls.from_system_config(
            EngineArgs(**kwargs).create_engine_configs())

    @classmethod
    def from_system_config(cls, config) -> BaseLLMEngine:
        return BaseLLMEngine(config)
