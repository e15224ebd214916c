"""Tokenizer utilities (ref: sarathi-lean transformers_utils/tokenizer.py).

Zero-egress friendly: ``get_tokenizer`` returns None for dummy/synthetic
models (benchmarks use token ids directly, like the reference's
load_format=dummy path); real tokenizers load from a local path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


def get_tokenizer(model: str, **kwargs):
    import glob
    import os

    # a checkpoint dir without tokenizer files (weights-only, e.g.
    # sharded-load benchmarks) also runs tokenizer-less; cover HF-fast
    # (tokenizer*), GPT-2 (vocab.json / vocab.txt + merges.txt) and
    # sentencepiece (spiece.model, *.model) layouts
    has_tok = os.path.isdir(model) and any(
        glob.glob(os.path.join(model, pat))
        for pat in ("tokenizer*", "vocab.json", "vocab.txt",
                    "merges.txt", "spiece.model", "*.model"))
    if not has_tok:
        logger.info(
            "No local tokenizer for %r; running tokenizer-less "
            "(token-id I/O only).", model)
        return None
    from transformers import AutoTokenizer

    # the files are local: never ask a hub
    kwargs.setdefault("local_files_only", True)
    return AutoTokenizer.from_pretrained(model, **kwargs)


def detokenize_incrementally(
    tokenizer,
    all_input_ids: List[int],
    prev_tokens: Optional[List[str]],
    prefix_offset: int,
    read_offset: int,
    skip_special_tokens: bool = False,
) -> Tuple[List[str], str, int, int]:
    """Incremental detokenization (ref tokenizer.py pattern from vLLM)."""
    new_token_id = all_input_ids[-1]
    if skip_special_tokens and new_token_id in tokenizer.all_special_ids:
        return [], "", prefix_offset, read_offset
    if prev_tokens is None:
        new_tokens = tokenizer.convert_ids_to_tokens(
            all_input_ids, skip_special_tokens=skip_special_tokens)
        output_tokens = new_tokens
        prefix_offset = max(len(output_tokens) - 6, 0)
        read_offset = max(len(output_tokens) - 1, 0)
    else:
        new_tokens = tokenizer.convert_ids_to_tokens(
            [new_token_id], skip_special_tokens=skip_special_tokens)
        output_tokens = prev_tokens + new_tokens

    prefix_text = tokenizer.convert_tokens_to_string(
        output_tokens[prefix_offset:read_offset])
    new_text = tokenizer.convert_tokens_to_string(
        output_tokens[prefix_offset:])
    if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
        new_text = new_text[len(prefix_text):]
        return new_tokens, new_text, read_offset, len(output_tokens)
    return new_tokens, "", prefix_offset, read_offset
