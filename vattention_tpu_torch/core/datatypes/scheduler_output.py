"""SchedulerOutputs (ref: sarathi-lean/sarathi/core/datatypes/scheduler_output.py:52)."""

from __future__ import annotations

from typing import List

from vattention_tpu_torch.core.datatypes.sequence import SequenceScheduleMetadata


class SchedulerOutputs:
    def __init__(
        self,
        id: int,
        ignored_seq_ids: List[str],
        preempted_seq_ids: List[str],
        scheduled_seq_metadata_list: List[SequenceScheduleMetadata],
    ) -> None:
        self.id = id
        self.ignored_seq_ids = ignored_seq_ids
        self.preempted_seq_ids = preempted_seq_ids
        self.scheduled_seq_metadata_list = scheduled_seq_metadata_list
        self.prompt_chunk_lens = [
            m.num_prompt_tokens for m in scheduled_seq_metadata_list]
        self.num_batched_prompt_tokens = sum(self.prompt_chunk_lens)
        self.num_batched_output_tokens = sum(
            1 for m in scheduled_seq_metadata_list if not m.is_prompt)
        self.num_batched_tokens = (
            self.num_batched_prompt_tokens + self.num_batched_output_tokens)

    def is_empty(self) -> bool:
        return not self.scheduled_seq_metadata_list

    def has_no_output(self) -> bool:
        return (not self.scheduled_seq_metadata_list
                and not self.ignored_seq_ids and not self.preempted_seq_ids)

    def seq_ids(self) -> List[str]:
        return [m.seq_id for m in self.scheduled_seq_metadata_list]

    def __repr__(self) -> str:
        return (f"SchedulerOutputs(id={self.id}, "
                f"scheduled={[m.seq_id for m in self.scheduled_seq_metadata_list]}, "
                f"preempted={self.preempted_seq_ids})")
