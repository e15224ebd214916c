"""BaseLLMEngine: the engine's serving loop.

Counterpart of ``vattention_tpu/engine/base_llm_engine.py`` on its
synchronous branch: poll free blocks -> schedule -> execute_model ->
on_step_completed, one device, in process.  The JAX package's async
dispatch (device-side token feedback, lagged host materialization) is
not ported yet, and asking for it raises.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.request_output import RequestOutput
from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.scheduler.scheduler_registry import SchedulerRegistry
from vattention_tpu_torch.core.sequence_manager.engine_sequence_manager import (
    EngineSequenceManager,
)
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.constants import CpuOperationMetrics
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.transformers_utils.tokenizer import get_tokenizer
from vattention_tpu_torch.utils.counter import Counter
from vattention_tpu_torch.worker.base_worker import BaseWorker

logger = init_logger(__name__)


def resolve_device(name: str) -> torch.device:
    """The engine's device: CUDA unless the caller asked for the CPU.
    Never falls back to the CPU when CUDA was asked for and is missing."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return device


class BaseLLMEngine:
    def __init__(self, config: SystemConfig):
        if config.enable_async_execution:
            raise NotImplementedError(
                "enable_async_execution is not ported yet "
                "(ROADMAP Queue 1 item 13)")
        pc = config.parallel_config
        if pc.tensor_parallel_size > 1 or pc.pipeline_parallel_size > 1:
            raise NotImplementedError(
                "tensor/pipeline parallelism is not ported yet "
                "(ROADMAP Queue 1 item 15)")
        self.config = config
        self.device = resolve_device(config.device)
        self.tokenizer = get_tokenizer(config.model_config.model)
        self.seq_manager = EngineSequenceManager(self.tokenizer)
        self.metrics_store = MetricsStore.get_or_create(config.metrics_config)
        self.seq_counter = Counter()

        self.worker = BaseWorker(config, self.device,
                                 seed=config.model_config.seed)
        num_blocks, memory_for_kv = self.worker.profile_num_available_blocks(
            config.cache_config.memory_utilization)
        config.cache_config.num_gpu_blocks = num_blocks
        config.cache_config.memory_for_gpu = memory_for_kv
        self.worker.init_cache_engine()

        # the scheduler's accounting granularity is the allocator's
        # page-derived KV-block size
        ce = self.worker.cache_engine
        config.cache_config.block_size = ce.block_tokens
        config.cache_config.num_gpu_blocks = ce.allocator.num_arena_blocks

        self.scheduler = SchedulerRegistry.get(
            config.scheduler_config.type, config.scheduler_config,
            config.cache_config)
        self.scheduler.set_block_manager(config.model_config)

    # ------------------------------------------------------------------ #
    def add_request(
        self,
        prompt: Optional[str],
        sampling_params: SamplingParams,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
        seq_id: Optional[str] = None,
    ) -> None:
        if arrival_time is None:
            arrival_time = time.monotonic()
        if prompt_token_ids is None:
            if self.tokenizer is None:
                raise ValueError("no tokenizer: pass prompt_token_ids")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if seq_id is None:
            seq_id = str(next(self.seq_counter))
        eos_token_id = (self.tokenizer.eos_token_id
                        if self.tokenizer is not None else -1)
        max_len = self.config.model_config.max_model_len
        if len(prompt_token_ids) >= max_len:
            raise ValueError(
                f"prompt of {len(prompt_token_ids)} tokens >= "
                f"max_model_len {max_len}")
        seq = Sequence(
            seq_id, prompt, prompt_token_ids,
            self.config.cache_config.block_size, eos_token_id,
            arrival_time, sampling_params,
            max_model_len=max_len)
        self.seq_manager.add_seq(seq)
        self.worker.add_seq(seq)
        self.scheduler.add_seq(seq)
        self.metrics_store.on_request_arrival(seq)

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished_seqs()

    def get_num_unfinished_requests(self) -> int:
        return self.scheduler.get_num_unfinished_seqs()

    # ------------------------------------------------------------------ #
    def step(self) -> List[RequestOutput]:
        """One serving iteration; returns this step's outputs."""
        if hasattr(self.scheduler.block_manager, "set_free_blocks"):
            self.scheduler.block_manager.set_free_blocks(
                self.worker.get_free_blocks())
        t0 = time.perf_counter()
        scheduler_outputs = self.scheduler.schedule()
        self.metrics_store.push_cpu_operation_time(
            CpuOperationMetrics.SCHEDULE, time.perf_counter() - t0)
        if scheduler_outputs.has_no_output():
            return []
        if scheduler_outputs.is_empty():
            self.scheduler.num_running_batches = max(
                0, self.scheduler.num_running_batches)
            return self._on_step_completed(scheduler_outputs, [], [], [])

        ignored_seqs, seq_metadata_list = self.seq_manager.on_schedule(
            scheduler_outputs)
        self.metrics_store.on_batch_start()
        self.metrics_store.on_step_dispatch(seq_metadata_list)
        sampler_outputs = self.worker.execute_model(
            scheduler_outputs, seq_metadata_list)
        return self._on_step_completed(
            scheduler_outputs, ignored_seqs, seq_metadata_list,
            sampler_outputs)

    def _on_step_completed(self, scheduler_outputs: SchedulerOutputs,
                           ignored_seqs, seq_metadata_list,
                           sampler_outputs) -> List[RequestOutput]:
        self.seq_manager.on_step_completed(scheduler_outputs,
                                           sampler_outputs)
        self.worker.on_step_completed(seq_metadata_list)
        self.scheduler.on_step_completed()
        for meta in seq_metadata_list:
            seq = meta.seq
            if seq.is_finished() and not getattr(seq, "_metrics_ended",
                                                 False):
                seq._metrics_ended = True
                self.metrics_store.on_request_end(seq)
        return self.seq_manager.generate_request_outputs(
            ignored_seqs, seq_metadata_list)

    # ------------------------------------------------------------------ #
    def get_metric_store(self) -> MetricsStore:
        return self.metrics_store

    def reset_metrics(self) -> None:
        self.metrics_store.reset()
        self.scheduler.reset_state()

    def cleanup(self) -> None:
        self.worker.cleanup()
