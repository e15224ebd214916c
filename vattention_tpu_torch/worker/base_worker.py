"""Worker: owns the model runner and cache engine for one device.

Counterpart of ``vattention_tpu/worker/base_worker.py`` for one device
and synchronous execution.  KV memory comes from the architecture's
parameter bytes and the device's memory: ``torch.cuda.mem_get_info`` on a
GPU, a fixed 2 GiB on the CPU (the JAX package's CPU figure, so both
packages size the same arena in the tests).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import SamplerOutputs, Sequence
from vattention_tpu_torch.core.sequence_manager.worker_sequence_manager import (
    WorkerSequenceManager,
)
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.constants import CpuOperationMetrics
from vattention_tpu_torch.metrics.metrics_store import MetricsStore

logger = init_logger(__name__)

# memory the CPU tier pretends to have (matches the JAX package)
_CPU_MEMORY_BYTES = 2 * 1024**3
# headroom for activations/workspace of a step on the GPU
_WORKSPACE_BYTES = 1 * 1024**3


class BaseWorker:
    def __init__(self, config: SystemConfig, device: torch.device, *,
                 seed: int = 0):
        self.config = config
        self.device = device
        self.seed = seed
        self.seq_manager = WorkerSequenceManager(
            config.cache_config, config.scheduler_config)
        self.metrics_store = MetricsStore.get_or_create(config.metrics_config)
        self.cache_engine = None
        self.model_runner = None

    # ------------------------------------------------------------------ #
    def _param_bytes(self) -> int:
        a = self.config.model_config.arch
        D = a.head_dim
        per_layer = (a.hidden_size * (a.num_q_heads + 2 * a.num_kv_heads) * D
                     + a.num_q_heads * D * a.hidden_size
                     + 3 * a.hidden_size * a.intermediate_size)
        total = a.num_layers * per_layer + 2 * a.vocab_size * a.hidden_size
        return total * self.config.model_config.dtype_bytes

    def profile_num_available_blocks(
            self, memory_utilization: float) -> tuple:
        """(num_blocks, bytes for the KV arena), by the JAX package's
        arithmetic over this device's memory."""
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            budget = min(free, total * memory_utilization)
            workspace = _WORKSPACE_BYTES
        else:
            budget = _CPU_MEMORY_BYTES * memory_utilization
            workspace = 0
        memory_for_kv = int(budget - self._param_bytes() - workspace)
        memory_for_kv = max(memory_for_kv, 64 * 1024 * 1024)

        # KV-block geometry (must match the allocator's math)
        cc = self.config.cache_config
        mc = self.config.model_config
        pc = self.config.parallel_config
        head_padded = -(-mc.get_head_size() // 128) * 128
        kv_bytes_per_token = (mc.get_num_kv_heads(pc) * head_padded
                              * mc.dtype_bytes * 2 * mc.get_num_layers(pc))
        kv_bytes_per_token_layer = (mc.get_num_kv_heads(pc)
                                    * head_padded * mc.dtype_bytes)
        block_tokens = max(1, cc.page_size // kv_bytes_per_token_layer)
        if block_tokens > 32:  # allocator rounds to 32-row multiples
            block_tokens -= block_tokens % 32
        # the arena never needs more than max concurrent context, plus one
        # block of growth slack per slot
        per_slot_tokens = (-(-mc.max_model_len // block_tokens) + 1) \
            * block_tokens
        max_useful = (cc.max_batch_size * per_slot_tokens
                      * kv_bytes_per_token)
        memory_for_kv = min(memory_for_kv, max_useful)
        num_blocks = memory_for_kv // (cc.block_size * kv_bytes_per_token)
        logger.info(
            "profiled: %.2f GB for KV cache -> %d blocks of %d tokens",
            memory_for_kv / 2**30, num_blocks, cc.block_size)
        return int(num_blocks), int(memory_for_kv)

    # ------------------------------------------------------------------ #
    def init_cache_engine(self) -> None:
        from vattention_tpu_torch.model_executor.model_runner import ModelRunner
        from vattention_tpu_torch.worker.cache_engine import get_cache_engine

        self.cache_engine = get_cache_engine(self.config, self.device)
        self.model_runner = ModelRunner(
            self.config, self.cache_engine, self.device, seed=self.seed)

    # ------------------------------------------------------------------ #
    def add_seq(self, seq: Sequence) -> None:
        self.seq_manager.add_seq(seq)

    def get_free_blocks(self) -> int:
        return self.cache_engine.get_free_blocks()

    def _cache_step(self, seq_metadata_list) -> None:
        t0 = time.perf_counter()
        self.cache_engine.step(seq_metadata_list)
        self.metrics_store.push_cpu_operation_time(
            CpuOperationMetrics.KV_STEP, time.perf_counter() - t0)
        self.metrics_store.fragmentation.add(
            self.cache_engine.allocator.fragmentation_overhead())

    def execute_model(self, scheduler_outputs: SchedulerOutputs,
                      seq_metadata_list) -> Optional[SamplerOutputs]:
        """Free preempted slots, grow the arena for this step, run it."""
        for seq_id in scheduler_outputs.preempted_seq_ids:
            self.cache_engine.free_seq(seq_id)
        self._cache_step(seq_metadata_list)
        t0 = time.perf_counter()
        sampler_outputs = self.model_runner.run(seq_metadata_list)
        self.metrics_store.push_cpu_operation_time(
            CpuOperationMetrics.MODEL_EXECUTION, time.perf_counter() - t0)
        self.metrics_store.on_batch_end(seq_metadata_list, scheduler_outputs)
        return sampler_outputs

    def on_step_completed(self, seq_metadata_list) -> None:
        """Free finished sequences' cache slots."""
        self.cache_engine.on_step_completion(seq_metadata_list)

    def cleanup(self) -> None:
        if self.cache_engine is not None:
            self.cache_engine.cleanup()
        if self.model_runner is not None:
            self.model_runner.params = None
        self.model_runner = None
