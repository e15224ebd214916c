"""BaseLLMEngine: the engine's serving loop.

Counterpart of ``vattention_tpu/engine/base_llm_engine.py``: poll free
blocks -> schedule -> execute_model -> on_step_completed, one device, in
process.  Async execution (the default, as in the JAX package) dispatches
each step and applies the samples of older steps as they land: the next
decode step reads its input tokens from the device, so the host never
waits for a step it has just dispatched, and at most
``max_inflight_steps`` steps are unresolved.  A request's first token
(TTFT) and its completion (e2e time, makespan) are stamped when the token
reaches the host, where the JAX engine stamps them at dispatch.

Under tensor or pipeline parallelism (``tensor_parallel_size`` x
``pipeline_parallel_size`` > 1) the engine is one rank's, in a process of
its own with the process group initialized: its worker holds the rank's
shard of the weights and of the arena, and the step's collectives span
the ranks (``parallel.mesh``).  Every rank runs the same schedule over the
same requests; only the driver (rank 0) writes metrics.  When
``LLMEngine`` started the other ranks itself, the driver's
``add_request`` stamps each request's arrival time and sequence id once
and sends the admission to the followers through the control plane
(``parallel.multihost``), ``step`` ticks them and ``cleanup`` stops them.
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
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.metrics.timer import OUTPUTS, SCHEDULE, STEP, span
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
        pc = config.parallel_config
        self.config = config
        self.device = resolve_device(config.device)
        self.mesh = None
        if pc.tensor_parallel_size * pc.pipeline_parallel_size > 1:
            from vattention_tpu_torch.parallel.mesh import make_serving_mesh

            self.mesh = make_serving_mesh(pc.tensor_parallel_size,
                                          pc.pipeline_parallel_size,
                                          device=self.device)
            if not self.mesh.is_driver:
                config.metrics_config.write_metrics = False
        # set by attach_ranks when this process started the other ranks
        self.control = None
        self._ranks = None
        self._tick = 0
        self.tokenizer = get_tokenizer(config.model_config.model)
        self.seq_manager = EngineSequenceManager(self.tokenizer)
        self.metrics_store = MetricsStore.get_or_create(config.metrics_config)
        self.seq_counter = Counter()

        self.worker = BaseWorker(config, self.device,
                                 seed=config.model_config.seed,
                                 mesh=self.mesh)
        num_blocks, memory_for_kv = self.worker.profile_num_available_blocks(
            config.cache_config.memory_utilization)
        config.cache_config.num_gpu_blocks = num_blocks
        config.cache_config.memory_for_gpu = memory_for_kv
        self.worker.init_cache_engine()

        # vattn arenas: the scheduler's accounting granularity is the
        # allocator's page-derived KV-block size (the paged pool keeps the
        # block size and count profiled above)
        allocator = getattr(self.worker.cache_engine, "allocator", None)
        if allocator is not None:
            config.cache_config.block_size = allocator.block_tokens
            config.cache_config.num_gpu_blocks = allocator.num_arena_blocks

        self.scheduler = SchedulerRegistry.get(
            config.scheduler_config.type, config.scheduler_config,
            config.cache_config)
        self.scheduler.set_block_manager(config.model_config)
        # async execution: host bookkeeping lags the device by at most
        # max_inflight_steps steps
        self.async_execution = config.enable_async_execution
        self.max_inflight_steps = config.max_inflight_steps

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
        if self.control is not None:
            # the followers admit it at the next tick, as stamped here
            self.control.submit(("add", dict(
                prompt=prompt, sampling_params=sampling_params,
                prompt_token_ids=prompt_token_ids,
                arrival_time=arrival_time, seq_id=seq_id)))
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
        return (self.scheduler.has_unfinished_seqs()
                or self.worker.has_inflight_steps())

    def get_num_unfinished_requests(self) -> int:
        return self.scheduler.get_num_unfinished_seqs()

    # ------------------------------------------------------------------ #
    def step(self) -> List[RequestOutput]:
        """One serving iteration.  Sync mode returns this step's outputs;
        async mode those of older steps whose samples have landed."""
        with span(self.metrics_store, STEP):
            return self._run_step()

    def _run_step(self) -> List[RequestOutput]:
        if self.control is not None:
            self.control.tick(self._tick)
            self._tick += 1
        if hasattr(self.scheduler.block_manager, "set_free_blocks"):
            self.scheduler.block_manager.set_free_blocks(
                self.worker.get_free_blocks())
        with span(self.metrics_store, SCHEDULE):
            scheduler_outputs = self.scheduler.schedule()
        if scheduler_outputs.has_no_output():
            if self.worker.has_inflight_steps():
                return self._process_resolved(self.worker.flush_inflight())
            return []
        if scheduler_outputs.is_empty():
            self.scheduler.num_running_batches = max(
                0, self.scheduler.num_running_batches)
            if self.worker.has_inflight_steps():
                return self._process_resolved(self.worker.flush_inflight())
            return self._on_step_completed(scheduler_outputs, [], [], [])

        outputs: List[RequestOutput] = []
        # a preemption folds generated tokens into the prompt: resolve the
        # in-flight values first so none are lost (none are in sync mode)
        if (scheduler_outputs.preempted_seq_ids
                and self.worker.has_inflight_steps()):
            outputs += self._process_resolved(self.worker.flush_inflight())
        ignored_seqs, seq_metadata_list = self.seq_manager.on_schedule(
            scheduler_outputs)
        self.metrics_store.on_batch_start()
        self.metrics_store.on_step_dispatch(seq_metadata_list)

        if not self.async_execution:
            sampler_outputs = self.worker.execute_model(
                scheduler_outputs, seq_metadata_list)
            return outputs + self._on_step_completed(
                scheduler_outputs, ignored_seqs, seq_metadata_list,
                sampler_outputs)

        resolved = self.worker.execute_model_async(
            scheduler_outputs, seq_metadata_list,
            max_inflight=self.max_inflight_steps)
        # the bookkeeping that needs no token value happens at dispatch:
        # prompt progress, pause transitions, pending placeholders, length
        # stops
        self.seq_manager.on_step_dispatched(scheduler_outputs)
        self.metrics_store.on_prompts_dispatched(seq_metadata_list)
        self.scheduler.on_step_completed()
        if ignored_seqs:
            outputs += self.seq_manager.generate_request_outputs(
                ignored_seqs, [])
        outputs += self._process_resolved(resolved)
        return outputs

    def _process_resolved(self, resolved) -> List[RequestOutput]:
        """Apply the samples of earlier dispatched steps: patch the token
        values in, run the stops that depend on them, free finished
        sequences and emit their RequestOutputs."""
        if not resolved:
            return []
        with span(self.metrics_store, OUTPUTS) as s:
            outputs: List[RequestOutput] = []
            for scheduler_outputs, seq_metadata_list, sampler_outputs \
                    in resolved:
                self.seq_manager.on_step_resolved(sampler_outputs)
                self.worker.on_step_completed(seq_metadata_list)
                # EOS and stop strings finish sequences between scheduler
                # ticks; retire them from the running queue
                self.scheduler.free_finished_seqs()
                self.scheduler.remove_finished_seqs()
                self._end_finished(seq_metadata_list)
                outputs += self.seq_manager.generate_request_outputs(
                    [], seq_metadata_list)
            if s.recording:
                s.counts.update(
                    outputs=len(outputs),
                    tokens_copied=sum(len(o.token_ids) for o in outputs))
        return outputs

    def _end_finished(self, seq_metadata_list) -> None:
        """Record the requests whose every sampled token has reached the
        host (a length stop finishes a request at dispatch, with tokens
        still pending)."""
        for meta in seq_metadata_list:
            seq = meta.seq
            if (seq.is_finished() and seq.num_pending_tokens == 0
                    and not getattr(seq, "_metrics_ended", False)):
                seq._metrics_ended = True
                seq.state.on_completion_observed()
                self.metrics_store.on_request_end(seq)

    def _on_step_completed(self, scheduler_outputs: SchedulerOutputs,
                           ignored_seqs, seq_metadata_list,
                           sampler_outputs) -> List[RequestOutput]:
        self.seq_manager.on_step_completed(scheduler_outputs,
                                           sampler_outputs)
        self.metrics_store.on_prompts_dispatched(seq_metadata_list)
        self.worker.on_step_completed(seq_metadata_list)
        self.scheduler.on_step_completed()
        self._end_finished(seq_metadata_list)
        return self.seq_manager.generate_request_outputs(
            ignored_seqs, seq_metadata_list)

    # ------------------------------------------------------------------ #
    def get_metric_store(self) -> MetricsStore:
        return self.metrics_store

    def reset_metrics(self) -> None:
        self.metrics_store.reset()
        self.scheduler.reset_state()

    # ------------------------------------------------------------------ #
    def attach_ranks(self, control, ranks) -> None:
        """Drive the follower ranks ``ranks`` (children of this process,
        ``parallel.multihost.start_engine_ranks``) through ``control``.
        They are killed if this process exits without ``cleanup``."""
        import atexit

        self.control = control
        self._ranks = ranks
        atexit.register(ranks.kill)

    def cleanup(self) -> None:
        self.worker.cleanup()
        if self.control is None:
            return
        import atexit

        import torch.distributed as dist

        ranks, self._ranks = self._ranks, None
        try:
            self.control.tick(self._tick, stop=True)
            self.control.close()
            ranks.join()
        finally:
            self.control = None
            ranks.kill()
            atexit.unregister(ranks.kill)
            ranks.remove()
            dist.destroy_process_group()
