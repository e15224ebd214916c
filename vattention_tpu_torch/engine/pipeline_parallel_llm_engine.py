"""Pipeline-parallel LLM engine.

Counterpart of ``vattention_tpu/engine/pipeline_parallel_llm_engine.py``.
The reference keeps ``num_pipeline_stages`` batches in flight with engine
threads and blocking send/recv between stage workers.  Here each step is
split into ``pp`` microbatches that occupy the stages together
(``parallel/pipeline.py``), so the scheduler sees one batch in flight and
the engine loop stays the synchronous one, as in the JAX package.
"""

from __future__ import annotations

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.engine.base_llm_engine import BaseLLMEngine
from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


class PipelineParallelLLMEngine(BaseLLMEngine):
    def __init__(self, config: SystemConfig):
        # the microbatches' concurrency lives inside the step
        config.scheduler_config.num_pipeline_stages = 1
        super().__init__(config)
        logger.info("pipeline-parallel engine: %d stages (GPipe over the "
                    "step's microbatches)",
                    config.parallel_config.pipeline_parallel_size)
