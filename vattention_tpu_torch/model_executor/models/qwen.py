"""Qwen / Qwen2.

Counterpart of vattention_tpu/model_executor/models/qwen.py: the Llama
body with a bias on the qkv projection (``ModelArch.qkv_bias``, set for
model_type "qwen" by config.py and by ``attention_bias`` in a config.json).
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


class QwenForCausalLM(LlamaForCausalLM):
    """Llama body; the qkv bias comes from ModelArch.qkv_bias."""


class Qwen2ForCausalLM(QwenForCausalLM):
    pass
