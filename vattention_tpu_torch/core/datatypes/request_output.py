"""RequestOutput (ref: sarathi-lean/sarathi/core/datatypes/request_output.py:9)."""

from __future__ import annotations

from typing import List, Optional

from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus


class RequestOutput:
    def __init__(
        self,
        seq_id: str,
        prompt: Optional[str],
        prompt_token_ids: List[int],
        text: str,
        token_ids: List[int],
        finished: bool,
        finish_reason: Optional[str] = None,
        logprobs: Optional[list] = None,
    ) -> None:
        self.seq_id = seq_id
        self.prompt = prompt
        self.prompt_token_ids = prompt_token_ids
        self.text = text
        self.token_ids = token_ids
        self.finished = finished
        self.finish_reason = finish_reason
        # per output token: (logprob, top_logprobs) or None where the
        # sampler output carried no logprobs
        self.logprobs = logprobs

    @property
    def cumulative_logprob(self) -> float:
        return sum(lp[0] for lp in (self.logprobs or []) if lp)

    @classmethod
    def from_seq(cls, seq: Sequence) -> "RequestOutput":
        return cls(
            seq.seq_id,
            seq.prompt,
            seq.prompt_token_ids,
            seq.output_text,
            # async execution: expose only host-materialized values (the
            # tail may still hold in-flight placeholders), and report
            # finished only once every sampled value has landed -- a
            # length-stop is decided at dispatch, 1-2 steps before the
            # final token values arrive
            list(seq.get_resolved_output_token_ids()),
            seq.is_finished() and seq.num_pending_tokens == 0,
            (SequenceStatus.get_finished_reason(seq.get_status())
             if seq.num_pending_tokens == 0 else None),
            logprobs=(
                [seq.output_logprobs.get(i) for i in range(
                    len(seq.get_resolved_output_token_ids()))]
                if seq.output_logprobs else None),
        )

    def __repr__(self) -> str:
        return (f"RequestOutput(seq_id={self.seq_id}, "
                f"finished={self.finished}, text={self.text[:40]!r})")
