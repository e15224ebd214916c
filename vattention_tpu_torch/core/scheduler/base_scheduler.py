"""Scheduler base: queue state, iteration gating, and admission plumbing.

Role parity: sarathi-lean/sarathi/core/scheduler/base_scheduler.py:20-155
(queues, FCFS policy, block-manager selection, preemption).  The
decomposition here is its own: queue movement is concentrated in the
``retire``/``evict`` helpers, pipeline gating wraps the subclass policy
in ``schedule()``, and admission-control memory accounting is delegated
to a block manager chosen once by ``set_block_manager``.

Two TPU-build-specific facts shape this class:

- Contiguous-arena (vATTN) backends always use the arena block manager,
  whatever scheduler policy runs on top -- physical commitment is
  tracked slab-granularly by the worker's allocator and mirrored here
  through the free-block feedback loop (the reference makes the same
  backend-overrides-scheduler choice).
- ``num_running_batches`` gates how many iterations may be in flight at
  once; pipeline-parallel engines raise the bound to the stage count so
  microbatches can overlap (in-flight batching), everything else runs
  at one.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from vattention_tpu_torch.config import BaseSchedulerConfig, CacheConfig
from vattention_tpu_torch.core.block_space_manager.block_space_manager_registry import (
    BlockSpaceManagerRegistry,
)
from vattention_tpu_torch.core.block_space_manager.vattention_block_space_manager import (
    vAttentionBlockSpaceManager,
)
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus
from vattention_tpu_torch.core.policy import PolicyFactory
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.model_executor.attention import AttentionBackend

logger = init_logger(__name__)


class BaseScheduler(ABC):
    """Owns the waiting/running queues and drives one policy subclass.

    Subclasses implement ``_schedule()`` only; everything queue- and
    lifecycle-shaped (iteration ids, pipeline gating, retiring finished
    sequences, preemption bookkeeping) lives here so the five policies
    stay small.
    """

    def __init__(self, scheduler_config: BaseSchedulerConfig,
                 cache_config: CacheConfig) -> None:
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        self.policy = PolicyFactory.get_policy(policy_name="fcfs")
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self.block_manager = None
        self.attention_backend: Optional[str] = None
        self._iteration_id = -1
        self.num_running_batches = 0

    # -- wiring ---------------------------------------------------------- #
    def set_block_manager(self, model_config) -> None:
        """Pick the admission-control accountant for this backend.

        Arena (vATTN) backends get the arena manager unconditionally --
        its free/promised-block model matches the worker allocator's
        slab accounting; block-table backends get the per-policy
        manager from the registry.
        """
        backend = model_config.attention_backend
        self.attention_backend = backend
        args = (self.cache_config.block_size,
                self.cache_config.num_gpu_blocks,
                self.scheduler_config.max_model_len)
        if AttentionBackend.is_vATTN(backend):
            self.block_manager = vAttentionBlockSpaceManager(*args)
        else:
            self.block_manager = BlockSpaceManagerRegistry.get(
                self.scheduler_config.type, *args)

    # -- queue interface ------------------------------------------------- #
    def add_seq(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def has_unfinished_seqs(self) -> bool:
        return len(self.waiting) + len(self.running) > 0

    def get_num_unfinished_seqs(self) -> int:
        return len(self.waiting) + len(self.running)

    def reset_state(self) -> None:
        self._iteration_id = -1

    # -- the per-iteration entry point ----------------------------------- #
    @abstractmethod
    def _schedule(self) -> SchedulerOutputs:
        """Policy hook: build this iteration's batch."""

    def schedule(self) -> SchedulerOutputs:
        """Run one scheduling tick unless the pipeline is saturated.

        With ``num_pipeline_stages`` batches already in flight the tick
        returns an empty marker output (the engine then only drains
        in-flight steps); otherwise the policy runs and, if it produced
        work, the in-flight count rises until ``on_step_completed``.
        """
        self._iteration_id += 1
        in_flight_cap = self.scheduler_config.num_pipeline_stages
        if self.num_running_batches >= in_flight_cap:
            return SchedulerOutputs(
                self._iteration_id, ignored_seq_ids=[],
                preempted_seq_ids=[], scheduled_seq_metadata_list=[])
        outputs = self._schedule()
        if not outputs.is_empty():
            self.num_running_batches += 1
        return outputs

    def on_step_completed(self) -> None:
        self.retire_finished_seqs()
        self.num_running_batches -= 1

    # -- lifecycle helpers ----------------------------------------------- #
    def retire_finished_seqs(self) -> None:
        """Release finished sequences' memory and drop them from the
        running queue (one pass; engines may also call the split halves
        below around async value resolution)."""
        self.free_finished_seqs()
        self.remove_finished_seqs()

    def free_finished_seqs(self) -> None:
        for seq in self.running:
            if seq.is_finished():
                self._free_seq(seq)

    def remove_finished_seqs(self) -> None:
        self.running = [s for s in self.running if not s.is_finished()]

    # -- memory-accounting passthroughs (used by policy subclasses) ------ #
    def _allocate(self, seq: Sequence) -> None:
        self.block_manager.allocate(seq)

    def _free_seq(self, seq: Sequence) -> None:
        self.block_manager.free(seq)

    def _append_slot(self, seq: Sequence) -> None:
        assert seq.is_executing()
        self.block_manager.append_slot(seq)

    def _preempt(self, seq: Sequence) -> None:
        """Evict a victim: release its memory now, queue it for a
        restart-from-scratch re-admission at the FRONT of the waiting
        queue (recompute folds its generated tokens back into the
        prompt; the sequence manager applies ``reset_for_recompute``).
        The arena manager additionally remembers the victim so the
        worker can reclaim its slab next step."""
        assert seq.is_executing()
        self._free_seq(seq)
        if isinstance(self.block_manager, vAttentionBlockSpaceManager):
            self.block_manager.preemption_queue.append(seq)
        self.waiting.insert(0, seq)

    def _check_request_prompt_length(self, seq: Sequence) -> bool:
        """Reject-and-ignore prompts that exceed the model context.

        Returns True when the sequence is admissible; on False the
        sequence has been marked FINISHED_IGNORED and popped from the
        waiting queue (callers record it in ignored_seq_ids).
        """
        limit = self.scheduler_config.max_model_len
        if seq.get_len() <= limit:
            return True
        logger.warning(
            "Input prompt (%d tokens) is too long and exceeds limit of %d",
            seq.get_len(), limit)
        seq.set_status(SequenceStatus.FINISHED_IGNORED)
        self.waiting.pop(0)
        return False
