"""Yi models (Yi-6B-200K, Yi-34B-200K).

Counterpart of vattention_tpu/model_executor/models/yi.py: the Llama body
with GQA, rope_theta=5e6 and 200K context, all carried by ModelArch
("yi-6b-200k", "yi-34b-200k" in config.py).
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


class YiForCausalLM(LlamaForCausalLM):
    """Llama body; Yi specifics live in ModelArch."""
