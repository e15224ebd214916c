"""EngineArgs -> config objects (counterpart of vattention_tpu/engine/arg_utils.py).

The same fields and defaults as the JAX package, with these
differences: ``device`` picks where the engine runs ("cuda" unless the
caller asks for "cpu"); ``enable_async_execution`` defaults to False
(only the synchronous step is ported); and the TPU-only
``dynamic_kv_len_buckets`` is gone (the CUDA kernels loop to each step's
live depth).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from vattention_tpu_torch.config import (
    KB, MB, CacheConfig, FasterTransformerSchedulerConfig, MetricsConfig,
    ModelConfig, OrcaSchedulerConfig, ParallelConfig, SarathiSchedulerConfig,
    SimpleChunkingSchedulerConfig, SystemConfig, VllmSchedulerConfig)
from vattention_tpu_torch.model_executor.attention import decode_page_size


@dataclass
class EngineArgs:
    model: str = "tiny-llama-debug"
    dtype: str = "bfloat16"
    seed: int = 0
    load_format: str = "dummy"
    max_model_len: Optional[int] = None
    attention_backend: str = "fa_vattn"
    max_logprobs: int = 0
    device: str = "cuda"
    # cache
    block_size: int = 256
    page_size: Optional[int] = None  # bytes; parsed from backend suffix too
    gpu_memory_utilization: float = 0.9
    max_batch_size: int = 64
    kv_quant: str = "none"
    use_native_allocator: "bool | None" = None
    # parallel
    pipeline_parallel_size: int = 1
    tensor_parallel_size: int = 1
    # scheduler
    scheduler_type: str = "sarathi"
    max_num_seqs: int = 64
    max_prefills_per_step: int = 4
    chunk_size: int = 512
    max_batched_tokens: Optional[int] = None
    enable_dynamic_chunking_schedule: bool = False
    low_chunk_size: Optional[int] = None
    high_chunk_size: Optional[int] = None
    chunk_schedule_max_tokens: Optional[int] = None
    chunk_schedule_stages: Optional[int] = None
    # metrics
    write_metrics: bool = False
    output_dir: str = "benchmark_output"
    enable_chrome_trace: bool = False
    enable_op_level_metrics: bool = False
    enable_plots: bool = False
    # execution
    enable_async_execution: bool = False
    max_inflight_steps: int = 2

    def create_engine_configs(self) -> SystemConfig:
        model_config = ModelConfig(
            model=self.model, dtype=self.dtype, seed=self.seed,
            load_format=self.load_format, max_model_len=self.max_model_len,
            attention_backend=self.attention_backend,
            max_logprobs=self.max_logprobs)
        page_size = self.page_size or decode_page_size(
            self.attention_backend, 2 * MB)
        if page_size < 16 * KB:
            # a bare block-size suffix (e.g. fa_paged_256) is in tokens
            block_size = page_size
            page_size = 2 * MB
        else:
            block_size = self.block_size
        cache_config = CacheConfig(
            block_size=block_size, page_size=page_size,
            memory_utilization=self.gpu_memory_utilization,
            max_batch_size=self.max_batch_size, kv_quant=self.kv_quant,
            use_native_allocator=self.use_native_allocator)
        parallel_config = ParallelConfig(
            pipeline_parallel_size=self.pipeline_parallel_size,
            tensor_parallel_size=self.tensor_parallel_size)
        max_model_len = model_config.max_model_len
        common = dict(max_num_seqs=self.max_num_seqs,
                      max_model_len=max_model_len,
                      max_prefills_per_step=self.max_prefills_per_step,
                      num_pipeline_stages=self.pipeline_parallel_size)
        st = self.scheduler_type.lower()
        if st == "sarathi":
            scheduler_config = SarathiSchedulerConfig(
                chunk_size=self.chunk_size,
                enable_dynamic_chunking_schedule=(
                    self.enable_dynamic_chunking_schedule),
                low_chunk_size=self.low_chunk_size,
                high_chunk_size=self.high_chunk_size,
                chunk_schedule_max_tokens=self.chunk_schedule_max_tokens,
                chunk_schedule_stages=self.chunk_schedule_stages, **common)
        elif st == "vllm":
            scheduler_config = VllmSchedulerConfig(
                max_batched_tokens=self.max_batched_tokens, **common)
        elif st == "simple_chunking":
            scheduler_config = SimpleChunkingSchedulerConfig(
                chunk_size=self.chunk_size, **common)
        elif st == "orca":
            scheduler_config = OrcaSchedulerConfig(**common)
        elif st == "faster_transformer":
            scheduler_config = FasterTransformerSchedulerConfig(**common)
        else:
            raise ValueError(f"unknown scheduler {self.scheduler_type!r}")
        metrics_config = MetricsConfig(
            write_metrics=self.write_metrics, output_dir=self.output_dir,
            enable_chrome_trace=self.enable_chrome_trace,
            enable_op_level_metrics=self.enable_op_level_metrics,
            enable_plots=self.enable_plots)
        return SystemConfig(
            model_config=model_config, cache_config=cache_config,
            parallel_config=parallel_config,
            scheduler_config=scheduler_config,
            metrics_config=metrics_config,
            enable_async_execution=self.enable_async_execution,
            max_inflight_steps=self.max_inflight_steps,
            device=self.device)

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]
