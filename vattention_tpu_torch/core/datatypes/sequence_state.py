"""Per-sequence timing/lifecycle state (ref: sarathi-lean/sarathi/core/datatypes/sequence_state.py)."""

from __future__ import annotations

import time
from typing import Optional

from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus


class SequenceState:
    def __init__(self, seq_id: str, arrival_time: float, num_prompt_tokens: int):
        self._id = seq_id
        self._arrival_time = arrival_time
        self._num_prompt_tokens = num_prompt_tokens
        self._num_output_tokens = 0
        self._status = SequenceStatus.WAITING
        self._scheduled_at: Optional[float] = None
        self._completed_at: Optional[float] = None
        self._prompt_processing_completed_at: Optional[float] = None
        self._last_token_generated_at: Optional[float] = None
        self._last_token_generation_time = 0.0
        self._execution_time = 0.0
        self._preempted_time = 0.0
        self._last_execution_start_at: Optional[float] = None
        self._num_restarts = 0
        self._num_pauses = 0
        self._is_ignored = False

    @property
    def status(self) -> SequenceStatus:
        return self._status

    @property
    def arrival_time(self) -> float:
        return self._arrival_time

    @property
    def scheduled_at(self) -> Optional[float]:
        return self._scheduled_at

    @property
    def completed_at(self) -> Optional[float]:
        return self._completed_at

    @property
    def prompt_processing_completed_at(self) -> Optional[float]:
        return self._prompt_processing_completed_at

    @property
    def e2e_time(self) -> Optional[float]:
        if self._completed_at is None:
            return None
        return self._completed_at - self._arrival_time

    @property
    def scheduling_delay(self) -> Optional[float]:
        if self._scheduled_at is None:
            return None
        return self._scheduled_at - self._arrival_time

    @property
    def e2e_prefill_time(self) -> Optional[float]:
        if self._prompt_processing_completed_at is None:
            return None
        return self._prompt_processing_completed_at - self._arrival_time

    @property
    def last_token_generation_time(self) -> float:
        return self._last_token_generation_time

    @property
    def num_restarts(self) -> int:
        return self._num_restarts

    def set_status(self, status: SequenceStatus) -> None:
        now = time.monotonic()
        if status == SequenceStatus.RUNNING and self._scheduled_at is None:
            self._scheduled_at = now
        if status == SequenceStatus.RUNNING:
            self._last_execution_start_at = now
        if status == SequenceStatus.PAUSED:
            self._num_pauses += 1
        if status == SequenceStatus.WAITING and SequenceStatus.is_executing(
                self._status):
            self._num_restarts += 1
        if SequenceStatus.is_finished(status):
            self._completed_at = now
        self._status = status

    def on_prompt_processing_completed(self) -> None:
        self._prompt_processing_completed_at = time.monotonic()

    def on_completion_observed(self) -> None:
        """The finished request's last token has reached the host.  Under
        async execution a length stop is decided when the last step is
        dispatched, a step or two before its token is read, so the
        completion is stamped again here (makespan, e2e time)."""
        self._completed_at = time.monotonic()

    def on_token_generated(self) -> None:
        now = time.monotonic()
        self._num_output_tokens += 1
        if self._last_token_generated_at is not None:
            self._last_token_generation_time = now - self._last_token_generated_at
        self._last_token_generated_at = now
