"""Write the port's params as a local HF-layout safetensors checkpoint.

The inverse of ``model_executor/weight_utils.load_safetensors`` for the
llama family: ``write_checkpoint`` writes ``config.json`` and one
``.safetensors`` file per layer plus one for the embeddings, the final
norm and the head, in the HF names and [out, in] layout, moving one layer
at a time to the host.  ``write_word_tokenizer`` adds a word-level
tokenizer in which token i is the word ``t<i>``, so a served text parses
back to its token ids (``parse_words``) and chat requests have a tokenizer
to encode with.  chip_smoke's phase (s) serves such a checkpoint at
yi-6b width; the tests write tiny ones.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from vattention_tpu_torch.config import ModelArch


def hf_config(arch: ModelArch) -> dict:
    """The config.json that ``config.get_model_arch`` reads back as
    ``arch``."""
    cfg = {
        "model_type": arch.model_type,
        "num_hidden_layers": arch.num_layers,
        "num_attention_heads": arch.num_q_heads,
        "num_key_value_heads": arch.num_kv_heads,
        "head_dim": arch.head_dim,
        "hidden_size": arch.hidden_size,
        "intermediate_size": arch.intermediate_size,
        "vocab_size": arch.vocab_size,
        "max_position_embeddings": arch.max_position_embeddings,
        "rope_theta": arch.rope_theta,
        "rms_norm_eps": arch.rms_norm_eps,
        "tie_word_embeddings": arch.tie_word_embeddings,
        "attention_bias": arch.qkv_bias,
        "sliding_window": arch.sliding_window,
    }
    if arch.rope_scaling is not None:
        cfg["rope_scaling"] = arch.rope_scaling
    return cfg


def layer_tensors(model, params, l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s HF tensors (views of ``params``, [out, in])."""
    a = model.arch
    qd, kvd, inter = a.q_dim, a.kv_dim, a.intermediate_size
    lp = params["layers"]
    p = f"model.layers.{l}."
    qkv, gate_up = lp["qkv_w"][l], lp["gate_up_w"][l]
    out = {
        p + "self_attn.q_proj.weight": qkv[:, :qd].T,
        p + "self_attn.k_proj.weight": qkv[:, qd:qd + kvd].T,
        p + "self_attn.v_proj.weight": qkv[:, qd + kvd:].T,
        p + "self_attn.o_proj.weight": lp["o_w"][l].T,
        p + "mlp.gate_proj.weight": gate_up[:, :inter].T,
        p + "mlp.up_proj.weight": gate_up[:, inter:].T,
        p + "mlp.down_proj.weight": lp["down_w"][l].T,
        p + "input_layernorm.weight": lp["input_norm"][l],
        p + "post_attention_layernorm.weight": lp["post_norm"][l],
    }
    if "qkv_b" in lp:
        b = lp["qkv_b"][l]
        out.update({p + "self_attn.q_proj.bias": b[:qd],
                    p + "self_attn.k_proj.bias": b[qd:qd + kvd],
                    p + "self_attn.v_proj.bias": b[qd + kvd:]})
    return out


def write_checkpoint(model, params, path) -> Tuple[int, int]:
    """Write ``params`` of ``model`` under ``path``; returns the bytes of
    tensor data written and the number of HF tensors."""
    from safetensors.torch import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config(model.arch)))
    L = model.arch.num_layers
    top = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        top["lm_head.weight"] = params["lm_head"].T
    shards = [layer_tensors(model, params, l) for l in range(L)] + [top]
    written = 0
    for i, shard in enumerate(shards):
        host = {k: v.contiguous().cpu() for k, v in shard.items()}
        save_file(host, str(path / f"model-{i + 1:05d}-of-{len(shards):05d}"
                                    ".safetensors"))
        written += sum(t.numel() * t.element_size() for t in host.values())
    return written, sum(len(shard) for shard in shards)


def write_word_tokenizer(path, vocab_size: int) -> None:
    """A word-level tokenizer of ``vocab_size`` words, token i the word
    ``t<i>`` (unknown words map to ``t0``), split on whitespace; no
    special tokens, so no EOS and no BOS."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"t{i}": i for i in range(vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="t0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    path = Path(path)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))


def words(token_ids) -> str:
    """The text ``write_word_tokenizer``'s tokenizer encodes as
    ``token_ids``."""
    return " ".join(f"t{i}" for i in token_ids)


def parse_words(text: str) -> List[int]:
    """Token ids back from a text of ``t<i>`` words."""
    return [int(m) for m in re.findall(r"t(\d+)", text)]
