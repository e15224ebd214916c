"""Base sequence manager (ref: sarathi-lean base_sequence_manager.py:58-133).

Replicates sequence state engine-side and worker-side: maps scheduler
outputs to live sequences, applies pause/resume/preempt transitions, and
ingests sampler outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from vattention_tpu_torch.core.datatypes.request_output import RequestOutput
from vattention_tpu_torch.core.datatypes.scheduler_output import SchedulerOutputs
from vattention_tpu_torch.core.datatypes.sequence import (
    SamplerOutput, SamplerOutputs, Sequence, SequenceMetadata)
from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus


class BaseSequenceManager:
    def __init__(self):
        self.seq_map: Dict[str, Sequence] = {}

    def add_seq(self, seq: Sequence) -> None:
        assert seq.seq_id not in self.seq_map
        self.seq_map[seq.seq_id] = seq

    def _free_seq(self, seq_id: str) -> None:
        assert seq_id in self.seq_map
        del self.seq_map[seq_id]

    def _preempt_seq(self, seq_id: str) -> None:
        seq = self.seq_map[seq_id]
        assert seq.is_executing()
        seq.reset_for_recompute()

    def _pause_seq(self, seq_id: str) -> None:
        seq = self.seq_map[seq_id]
        assert seq.is_running(), f"seq_id: {seq_id}, status: {seq.get_status()}"
        seq.set_status(SequenceStatus.PAUSED)

    def _resume_seq(self, seq_id: str) -> None:
        seq = self.seq_map[seq_id]
        assert seq.is_waiting() or seq.is_paused()
        seq.set_status(SequenceStatus.RUNNING)

    def _on_seq_scheduled(self, seq_sched_metadata) -> None:
        assert seq_sched_metadata.seq_id in self.seq_map
        self._resume_seq(seq_sched_metadata.seq_id)

    def _on_append_token(self, seq: Sequence) -> None:
        pass

    def on_schedule(
        self, scheduler_outputs: SchedulerOutputs,
    ) -> Tuple[List[Sequence], List[SequenceMetadata]]:
        ignored_seqs: List[Sequence] = []
        for seq_id in scheduler_outputs.ignored_seq_ids:
            if seq_id not in self.seq_map:
                continue
            seq = self.seq_map[seq_id]
            ignored_seqs.append(seq)
            self._free_seq(seq_id)
        for seq_id in scheduler_outputs.preempted_seq_ids:
            self._preempt_seq(seq_id)
        seq_metadata_list: List[SequenceMetadata] = []
        for meta in scheduler_outputs.scheduled_seq_metadata_list:
            self._on_seq_scheduled(meta)
            seq = self.seq_map[meta.seq_id]
            seq_metadata_list.append(
                SequenceMetadata(seq, meta.prompt_chunk_len))
        return ignored_seqs, seq_metadata_list

    def _process_seq_output(self, seq: Sequence,
                            sample: SamplerOutput) -> None:
        if not seq.prompt_processing_finished:
            return
        seq.append_token_id(sample.output_token)
        seq.set_logprob(len(seq.output_token_ids) - 1, sample.logprob,
                        sample.top_logprobs)
        self._on_append_token(seq)
        seq.check_stop()

    def on_step_completed(self, scheduler_outputs: SchedulerOutputs,
                          sampler_outputs: Optional[SamplerOutputs]) -> None:
        sampler_map = {s.seq_id: s for s in (sampler_outputs or [])}
        for meta in scheduler_outputs.scheduled_seq_metadata_list:
            seq = self.seq_map[meta.seq_id]
            if not seq.is_running():
                # preempted/finished mid-flight
                continue
            if meta.is_prompt:
                seq.update_prompt_tokens_processed(meta.prompt_chunk_len)
            self._pause_seq(meta.seq_id)
            if meta.seq_id in sampler_map and seq.prompt_processing_finished:
                self._process_seq_output(seq, sampler_map[meta.seq_id])

    # -- async execution: host bookkeeping split around the device step -- #
    def on_step_dispatched(self, scheduler_outputs: SchedulerOutputs) -> None:
        """Length bookkeeping at dispatch time, before sampled values reach
        the host: prompt progress, pause transitions, pending-token
        placeholders, and length-based stops (all value-independent)."""
        for meta in scheduler_outputs.scheduled_seq_metadata_list:
            seq = self.seq_map[meta.seq_id]
            if not seq.is_running():
                continue
            if meta.is_prompt:
                seq.update_prompt_tokens_processed(meta.prompt_chunk_len)
            self._pause_seq(meta.seq_id)
            if seq.prompt_processing_finished:
                seq.append_pending_token()
                seq.check_length_stop()

    def _on_token_resolved(self, seq: Sequence, output_idx: int) -> None:
        """Value-dependent stop checks once the token value lands.  The
        engine subclass extends this with incremental detokenization."""
        token_id = seq.output_token_ids[output_idx]
        sp = seq.sampling_params
        if not sp.ignore_eos and token_id == seq.eos_token_id:
            seq.truncate_and_finish(output_idx,
                                    SequenceStatus.FINISHED_STOPPED)

    def on_step_resolved(self, sampler_outputs: SamplerOutputs) -> None:
        """Patch device-sampled values into their placeholders (in dispatch
        order) and run the value-dependent stop checks."""
        for sample in sampler_outputs:
            seq = self.seq_map.get(sample.seq_id)
            if seq is None or seq.num_pending_tokens == 0:
                continue  # freed or invalidated since dispatch
            idx = seq.resolve_pending_token(sample.output_token)
            seq.set_logprob(idx, sample.logprob, sample.top_logprobs)
            self._on_token_resolved(seq, idx)

    def generate_request_outputs(
        self, ignored_seqs: List[Sequence],
        seq_metadata_list: List[SequenceMetadata],
    ) -> List[RequestOutput]:
        all_seqs = ignored_seqs + [m.seq for m in seq_metadata_list]
        return [RequestOutput.from_seq(seq) for seq in all_seqs]
