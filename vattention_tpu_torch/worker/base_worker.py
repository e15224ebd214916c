"""Worker: owns the model runner and cache engine for one device.

Counterpart of ``vattention_tpu/worker/base_worker.py`` for one device,
synchronous (``execute_model``) and asynchronous (``execute_model_async``:
a queue of dispatched steps whose samples the host reads up to
``max_inflight`` steps later).  KV memory comes from the architecture's
parameter bytes and the device's memory: ``torch.cuda.mem_get_info`` on a
GPU, a fixed 2 GiB on the CPU (the JAX package's CPU figure, so both
packages size the same arena in the tests).  ``start_profiling`` and
``stop_profiling`` trace through ``torch.profiler`` into a chrome trace,
as the reference's worker does.

Under tensor or pipeline parallelism the worker is one rank's (its
``mesh``): it builds on the rank's device, counts the layer weights of one
tp shard in the memory profile (the JAX ``_param_bytes``), and ends the
profile with the minimum of the block count and arena bytes over all
ranks, so that every rank's scheduler and allocator make the same
decisions although co-located ranks see different free memory.  Its
dispatched steps resolve by count alone (``max_inflight``), never by
whether a step's samples have landed, which differs between ranks.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import SamplerOutputs, Sequence
from vattention_tpu_torch.core.sequence_manager.worker_sequence_manager import (
    WorkerSequenceManager,
)
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.metrics.timer import KV_STEP, RESOLVE_WAIT, span

logger = init_logger(__name__)

# memory the CPU tier pretends to have (matches the JAX package)
_CPU_MEMORY_BYTES = 2 * 1024**3
# headroom for activations/workspace of a step on the GPU
_WORKSPACE_BYTES = 1 * 1024**3


def param_bytes(model_config, tp: int = 1) -> int:
    """The weights' bytes on one rank's device (the JAX package's
    arithmetic: the layer weights of one tp shard, the embeddings and the
    head whole; every layer counted, whatever the pipeline stage)."""
    a = model_config.arch
    D = a.head_dim
    per_layer = (a.hidden_size * (a.num_q_heads + 2 * a.num_kv_heads) * D
                 + a.num_q_heads * D * a.hidden_size
                 + 3 * a.hidden_size * a.intermediate_size)
    total = (a.num_layers * per_layer // tp
             + 2 * a.vocab_size * a.hidden_size)
    return total * model_config.dtype_bytes


def device_memory(device: torch.device) -> tuple:
    """(free, total, workspace) bytes of ``device``: the workspace is left
    aside for a step's activations; the CPU tier has a fixed total."""
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return free, total, _WORKSPACE_BYTES
    return _CPU_MEMORY_BYTES, _CPU_MEMORY_BYTES, 0


class BaseWorker:
    def __init__(self, config: SystemConfig, device: torch.device, *,
                 seed: int = 0, mesh=None):
        self.config = config
        self.device = device
        self.seed = seed
        self.mesh = mesh
        self.seq_manager = WorkerSequenceManager(
            config.cache_config, config.scheduler_config)
        self.metrics_store = MetricsStore.get_or_create(config.metrics_config)
        self.cache_engine = None
        self.model_runner = None
        # dispatched steps not yet resolved: [(scheduler_outputs, handle)]
        self._inflight: List[tuple] = []

    # ------------------------------------------------------------------ #
    def profile_num_available_blocks(
            self, memory_utilization: float) -> tuple:
        """(num_blocks, bytes for the KV arena), by the JAX package's
        arithmetic over this device's memory."""
        free, total, workspace = device_memory(self.device)
        budget = min(free, total * memory_utilization)
        memory_for_kv = int(budget - param_bytes(
            self.config.model_config,
            self.config.parallel_config.tensor_parallel_size) - workspace)
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
        if self.mesh is not None:
            num_blocks, memory_for_kv = self.mesh.all_reduce_min(
                [num_blocks, memory_for_kv])
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
            self.config, self.cache_engine, self.device, seed=self.seed,
            mesh=self.mesh)

    # ------------------------------------------------------------------ #
    def add_seq(self, seq: Sequence) -> None:
        self.seq_manager.add_seq(seq)

    def get_free_blocks(self) -> int:
        return self.cache_engine.get_free_blocks()

    def _cache_step(self, seq_metadata_list) -> None:
        with span(self.metrics_store, KV_STEP) as s:
            if s.recording:
                moves = getattr(self.cache_engine, "pending_moves", 0)
            self.cache_engine.step(seq_metadata_list)
            if s.recording:
                s.counts["moves"] = getattr(
                    self.cache_engine, "pending_moves", 0) - moves
        allocator = getattr(self.cache_engine, "allocator", None)
        if allocator is not None:
            self.metrics_store.fragmentation.add(
                allocator.fragmentation_overhead())

    def execute_model(self, scheduler_outputs: SchedulerOutputs,
                      seq_metadata_list) -> Optional[SamplerOutputs]:
        """Free preempted slots, grow the arena for this step, run it."""
        for seq_id in scheduler_outputs.preempted_seq_ids:
            self.cache_engine.free_seq(seq_id)
        self._cache_step(seq_metadata_list)
        sampler_outputs = self.model_runner.run(seq_metadata_list)
        self.metrics_store.on_batch_end(seq_metadata_list, scheduler_outputs)
        return sampler_outputs

    # -- async execution ------------------------------------------------- #
    def execute_model_async(self, scheduler_outputs: SchedulerOutputs,
                            seq_metadata_list,
                            max_inflight: int = 2) -> List[tuple]:
        """Dispatch this step without waiting for its samples and return
        the OLDER steps whose samples have landed: [(scheduler_outputs,
        seq_metadata_list, sampler_outputs), ...].  At most
        ``max_inflight`` steps stay unresolved, so the host's bookkeeping
        runs one or two steps behind the device."""
        for seq_id in scheduler_outputs.preempted_seq_ids:
            self.cache_engine.free_seq(seq_id)
        self._cache_step(seq_metadata_list)
        handle = self.model_runner.run_async(seq_metadata_list)
        self.metrics_store.on_batch_end(seq_metadata_list, scheduler_outputs)
        self._inflight.append((scheduler_outputs, handle))
        resolved = []
        while self._inflight and (
                len(self._inflight) > max_inflight
                or (self.mesh is None and self._inflight[0][1].is_ready())):
            resolved.append(self._resolve_oldest())
        return resolved

    def _resolve_oldest(self, flush: int = 0) -> tuple:
        scheduler_outputs, handle = self._inflight.pop(0)
        with span(self.metrics_store, RESOLVE_WAIT, flush=flush):
            handle.wait()
        sampler_outputs = self.model_runner.resolve(handle)
        return scheduler_outputs, handle.seq_metadata_list, sampler_outputs

    def flush_inflight(self) -> List[tuple]:
        """Resolve every dispatched step (waits for the last one)."""
        resolved = []
        while self._inflight:
            resolved.append(self._resolve_oldest(flush=1))
        return resolved

    def has_inflight_steps(self) -> bool:
        return bool(self._inflight)

    def on_step_completed(self, seq_metadata_list) -> None:
        """Free finished sequences' cache slots."""
        self.cache_engine.on_step_completion(seq_metadata_list)

    def profile_op_level(self, *, ctx: int = 1024, iters: int = 8) -> dict:
        """Per-op times (OperationMetrics rows) at this worker's serving
        shapes; see metrics/op_profiler.py."""
        from vattention_tpu_torch.metrics.op_profiler import profile_operations

        return profile_operations(self.model_runner, ctx=ctx, iters=iters)

    # -- profiling: torch.profiler -> chrome trace ------------------------ #
    def start_profiling(self, output_dir: str = "profiler_output") -> None:
        from vattention_tpu_torch.metrics.timer import profile_session

        self._profiling = contextlib.ExitStack()
        self._profiling.enter_context(profile_session(
            output_dir, cuda=self.device.type == "cuda"))
        self._profiling_dir = output_dir

    def stop_profiling(self) -> str:
        """Stop the trace; returns the chrome trace's path."""
        self._profiling.close()
        path = os.path.join(self._profiling_dir, "trace.json")
        logger.info("profiler trace written to %s", path)
        return path

    def cleanup(self) -> None:
        if self.cache_engine is not None:
            self.cache_engine.cleanup()
        # drop the device references (weights, graphs and their pool, the
        # token buffer, the staging buffers): an A/B harness builds the
        # next engine right after this one
        if self.model_runner is not None:
            self.model_runner.cleanup()
        self.model_runner = None
        self._inflight.clear()
