"""LLMEngine facade (counterpart of vattention_tpu/engine/llm_engine.py).

Pipeline parallelism routes to ``PipelineParallelLLMEngine``.  A tp x pp
engine asked for from a process without a process group starts the other
ranks as child processes (``parallel.multihost.start_engine_ranks``: rank
r on ``cuda:{r % device_count}``, or on the CPU) and returns rank 0's
engine, which drives them; so the single-process calling code of the JAX
package runs unchanged.  In a process whose group is up (a rank of
``python -m vattention_tpu_torch.parallel.multihost``) it returns that
rank's engine.
"""

from __future__ import annotations

import torch.distributed as dist

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
        from vattention_tpu_torch.parallel import multihost

        pc = config.parallel_config
        if (pc.tensor_parallel_size * pc.pipeline_parallel_size > 1
                and not dist.is_initialized()):
            return multihost.start_engine_ranks(config)
        return multihost.engine_class(config)(config)
