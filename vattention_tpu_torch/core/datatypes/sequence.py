"""Sequence and schedule-metadata datatypes.

ref: sarathi-lean/sarathi/core/datatypes/sequence.py:11-298.  The logical
token-block list of the reference is replaced by simple length math (block
accounting lives in the block-space managers).
"""

from __future__ import annotations

from typing import List, Optional

from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams
from vattention_tpu_torch.core.datatypes.sequence_state import SequenceState
from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus


class Sequence:
    def __init__(
        self,
        seq_id: str,
        prompt: Optional[str],
        prompt_token_ids: List[int],
        block_size: int,
        eos_token_id: int,
        arrival_time: float,
        sampling_params: SamplingParams,
        max_model_len: Optional[int] = None,
    ) -> None:
        self.seq_id = seq_id
        self.prompt = prompt
        self.block_size = block_size
        self.eos_token_id = eos_token_id
        self.arrival_time = arrival_time
        self.sampling_params = sampling_params
        self.max_model_len = max_model_len
        self.prompt_token_ids = list(prompt_token_ids)

        self.output_token_ids: List[int] = []
        # output index -> (logprob, top_logprobs) for tokens whose
        # sampler output carried logprobs; sparse dict so truncation /
        # re-resolution after preemption just overwrites by index
        self.output_logprobs: dict = {}
        self.prompt_tokens_processed = 0
        self.prompt_processing_finished = False
        # async-execution state: sampled-on-device tokens not yet
        # materialized host-side are PENDING_TOKEN_ID placeholders at the
        # tail of output_token_ids; `generation` invalidates in-flight
        # results across preemption restarts / value-stop truncations
        self.num_pending_tokens = 0
        self.generation = 0

        self.output_text = ""
        # incremental detokenization state
        self.prefix_offset = 0
        self.read_offset = 0
        self.tokens: Optional[List[str]] = None

        self.state = SequenceState(seq_id, arrival_time, len(prompt_token_ids))

    # -- status ---------------------------------------------------------- #
    def get_status(self) -> SequenceStatus:
        return self.state.status

    def set_status(self, status: SequenceStatus) -> None:
        self.state.set_status(status)

    def is_finished(self) -> bool:
        return SequenceStatus.is_finished(self.get_status())

    def is_executing(self) -> bool:
        return SequenceStatus.is_executing(self.get_status())

    def is_waiting(self) -> bool:
        return SequenceStatus.is_waiting(self.get_status())

    def is_paused(self) -> bool:
        return SequenceStatus.is_paused(self.get_status())

    def is_running(self) -> bool:
        return SequenceStatus.is_running(self.get_status())

    # -- token bookkeeping ------------------------------------------------ #
    def update_prompt_tokens_processed(self, num_tokens: int) -> None:
        assert not self.prompt_processing_finished
        assert num_tokens > 0
        self.prompt_tokens_processed += num_tokens
        assert self.prompt_tokens_processed <= len(self.prompt_token_ids)
        if self.prompt_tokens_processed == len(self.prompt_token_ids):
            self.prompt_processing_finished = True
            self.state.on_prompt_processing_completed()

    def append_token_id(self, token_id: int) -> None:
        assert self.prompt_processing_finished
        self.output_token_ids.append(token_id)
        self.state.on_token_generated()

    def set_logprob(self, output_idx: int, logprob: float,
                    top_logprobs=None) -> None:
        self.output_logprobs[output_idx] = (logprob, top_logprobs)

    # -- async execution (one-step-lagged host materialization) ---------- #
    PENDING_TOKEN_ID = -1

    def append_pending_token(self) -> None:
        """Length bookkeeping for a token sampled on device whose value has
        not reached the host yet (async execution).  The value arrives via
        ``resolve_pending_token``; lengths/positions are exact meanwhile."""
        assert self.prompt_processing_finished
        self.output_token_ids.append(self.PENDING_TOKEN_ID)
        self.num_pending_tokens += 1
        self.state.on_token_generated()

    def resolve_pending_token(self, token_id: int) -> int:
        """Patch the oldest pending placeholder; returns its output index."""
        assert self.num_pending_tokens > 0
        idx = len(self.output_token_ids) - self.num_pending_tokens
        self.output_token_ids[idx] = token_id
        self.num_pending_tokens -= 1
        return idx

    def drop_pending_tokens(self) -> None:
        if self.num_pending_tokens:
            del self.output_token_ids[-self.num_pending_tokens:]
            self.num_pending_tokens = 0
        self.generation += 1

    def get_resolved_output_token_ids(self) -> List[int]:
        if self.num_pending_tokens:
            return self.output_token_ids[:-self.num_pending_tokens]
        return self.output_token_ids

    def check_length_stop(self) -> None:
        """Length-based stop only — decidable at dispatch time, before the
        sampled values reach the host (async execution)."""
        if self.get_output_len() >= self.sampling_params.max_tokens:
            self.set_status(SequenceStatus.FINISHED_LENGTH_CAPPED)
        elif (self.max_model_len is not None
                and self.get_len() >= self.max_model_len):
            # hard context cap: the KV slab is sized for max_model_len
            # tokens, so decoding past it would overflow the arena slot
            self.set_status(SequenceStatus.FINISHED_LENGTH_CAPPED)

    def truncate_and_finish(self, output_idx: int,
                            status: SequenceStatus) -> None:
        """Value-dependent stop landed at `output_idx`: drop speculative
        tokens sampled after it and invalidate their in-flight results."""
        del self.output_token_ids[output_idx + 1:]
        self.num_pending_tokens = 0
        self.generation += 1
        self.set_status(status)

    def get_len(self) -> int:
        return len(self.output_token_ids) + len(self.prompt_token_ids)

    def get_prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    def get_output_len(self) -> int:
        return len(self.output_token_ids)

    def get_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    def get_num_prompt_tokens_processed(self) -> int:
        return self.prompt_tokens_processed

    def get_last_token_id(self) -> int:
        if not self.output_token_ids:
            return self.prompt_token_ids[-1]
        return self.output_token_ids[-1]

    def get_output_token_ids(self) -> List[int]:
        return self.output_token_ids

    def get_next_prompt_chunk_token_ids(self, chunk_size: int) -> List[int]:
        start = self.prompt_tokens_processed
        end = start + chunk_size
        assert end <= len(self.prompt_token_ids)
        return self.prompt_token_ids[start:end]

    def get_next_prompt_chunk_len(self, chunk_size: int) -> int:
        return min(chunk_size,
                   len(self.prompt_token_ids) - self.prompt_tokens_processed)

    def reset_for_recompute(self) -> None:
        """Preemption restart (ref sequence.py:158)."""
        self.drop_pending_tokens()  # in-flight values can't be recovered
        self.set_status(SequenceStatus.WAITING)
        self.prompt_tokens_processed = 0
        self.prompt_processing_finished = False
        self.prompt_token_ids = self.prompt_token_ids + self.output_token_ids
        self.output_token_ids = []

    def check_stop(self) -> None:
        for stop_str in self.sampling_params.stop:
            if self.output_text.endswith(stop_str):
                self.output_text = self.output_text[:-len(stop_str)]
                self.set_status(SequenceStatus.FINISHED_STOPPED)
                return
        if self.get_output_len() == self.sampling_params.max_tokens:
            self.set_status(SequenceStatus.FINISHED_LENGTH_CAPPED)
            return
        if (not self.sampling_params.ignore_eos
                and self.get_last_token_id() == self.eos_token_id):
            self.set_status(SequenceStatus.FINISHED_STOPPED)
            return

    def __repr__(self) -> str:
        return (f"Sequence(seq_id={self.seq_id}, "
                f"status={self.get_status().name}, len={self.get_len()})")


class SequenceScheduleMetadata:
    """Scheduler -> worker description of one scheduled sequence.

    ref: sequence.py:195-252.
    """

    def __init__(self, seq_id: str, prompt_chunk_len: Optional[int] = None):
        self.seq_id = seq_id
        self.prompt_chunk_len = prompt_chunk_len if prompt_chunk_len else 0

    @property
    def num_prompt_tokens(self) -> int:
        return self.prompt_chunk_len

    @property
    def is_prompt(self) -> bool:
        return self.prompt_chunk_len > 0

    @classmethod
    def from_sequence(cls, seq: Sequence,
                      prompt_chunk_len: Optional[int] = None
                      ) -> "SequenceScheduleMetadata":
        return cls(seq_id=seq.seq_id, prompt_chunk_len=prompt_chunk_len)

    def __repr__(self) -> str:
        return (f"SequenceScheduleMetadata(seq_id={self.seq_id}, "
                f"prompt_chunk_len={self.prompt_chunk_len})")


class SequenceMetadata:
    """Worker-side materialization with the live Sequence (ref :255-298)."""

    def __init__(self, seq: Sequence, prompt_chunk_len: Optional[int] = None):
        self.seq = seq
        self.prompt_chunk_len = prompt_chunk_len if prompt_chunk_len else 0

    @property
    def seq_id(self) -> str:
        return self.seq.seq_id

    @property
    def is_prompt(self) -> bool:
        return self.prompt_chunk_len > 0

    @property
    def num_prompt_tokens(self) -> int:
        return self.prompt_chunk_len

    def __repr__(self) -> str:
        return (f"SequenceMetadata(seq_id={self.seq.seq_id}, "
                f"prompt_chunk_len={self.prompt_chunk_len})")


class SamplerOutput:
    """Output token for one sequence (ref sequence.py:301+).

    ``logprob``: log-probability of the sampled token under the raw
    (pre-temperature) distribution; ``top_logprobs``: optional
    [(token_id, logprob)] of the step's top-N alternatives (engine
    ``max_logprobs``)."""

    def __init__(self, seq_id: str, output_token: int,
                 logprob: float = 0.0, top_logprobs=None):
        self.seq_id = seq_id
        self.output_token = output_token
        self.logprob = logprob
        self.top_logprobs = top_logprobs

    def __repr__(self) -> str:
        return f"SamplerOutput(seq_id={self.seq_id}, token={self.output_token})"


SamplerOutputs = List[SamplerOutput]
