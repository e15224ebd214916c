"""Engine-side sequence manager: adds incremental detokenization.

ref: sarathi-lean engine_sequence_manager.py:16-35.
"""

from __future__ import annotations

from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.sequence_manager.base_sequence_manager import (
    BaseSequenceManager,
)
from vattention_tpu_torch.transformers_utils.tokenizer import (
    detokenize_incrementally,
)


class EngineSequenceManager(BaseSequenceManager):
    def __init__(self, tokenizer):
        super().__init__()
        self.tokenizer = tokenizer

    def _decode_seq(self, seq: Sequence, upto: int = None) -> None:
        """Incremental detok; `upto` bounds it to resolved output tokens so
        trailing async placeholders are never decoded."""
        if self.tokenizer is None:
            return
        ids = seq.get_token_ids()
        if upto is not None:
            ids = ids[:seq.get_prompt_len() + upto + 1]
        (new_tokens, new_output_text, prefix_offset,
         read_offset) = detokenize_incrementally(
            self.tokenizer,
            all_input_ids=ids,
            prev_tokens=seq.tokens,
            prefix_offset=seq.prefix_offset,
            read_offset=seq.read_offset,
            skip_special_tokens=True,
        )
        if seq.tokens is None:
            seq.tokens = new_tokens
        else:
            seq.tokens.extend(new_tokens)
        seq.output_text += new_output_text
        seq.prefix_offset = prefix_offset
        seq.read_offset = read_offset

    def _on_append_token(self, seq: Sequence) -> None:
        self._decode_seq(seq)

    def _on_token_resolved(self, seq: Sequence, output_idx: int) -> None:
        from vattention_tpu_torch.core.datatypes.sequence_status import (
            SequenceStatus,
        )

        self._decode_seq(seq, upto=output_idx)
        for stop_str in seq.sampling_params.stop:
            if seq.output_text.endswith(stop_str):
                seq.output_text = seq.output_text[:-len(stop_str)]
                seq.truncate_and_finish(output_idx,
                                        SequenceStatus.FINISHED_STOPPED)
                return
        super()._on_token_resolved(seq, output_idx)
