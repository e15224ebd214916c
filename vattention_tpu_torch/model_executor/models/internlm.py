"""InternLM-20B.

Counterpart of vattention_tpu/model_executor/models/internlm.py: the Llama
body with a bias on the qkv projection (``ModelArch.qkv_bias``, set for
model_type "internlm" by config.py).
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


class InternLMForCausalLM(LlamaForCausalLM):
    """Llama body; the qkv bias comes from ModelArch.qkv_bias."""
