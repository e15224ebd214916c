"""Model registry (counterpart of vattention_tpu/model_executor/models/__init__.py).

llama, yi, mistral, qwen, qwen2, internlm and opt share the llama-family
body (their differences are ModelArch data: a sliding window, a qkv bias);
falcon has its own parallel-attention layer on the same serving path.
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


def get_model_class(model_type: str):
    from vattention_tpu_torch.model_executor.models.falcon import (
        FalconForCausalLM)
    from vattention_tpu_torch.model_executor.models.internlm import (
        InternLMForCausalLM)
    from vattention_tpu_torch.model_executor.models.mistral import (
        MistralForCausalLM)
    from vattention_tpu_torch.model_executor.models.qwen import (
        Qwen2ForCausalLM, QwenForCausalLM)
    from vattention_tpu_torch.model_executor.models.yi import YiForCausalLM

    registry = {
        "llama": LlamaForCausalLM,
        "yi": YiForCausalLM,
        "mistral": MistralForCausalLM,
        "qwen": QwenForCausalLM,
        "qwen2": Qwen2ForCausalLM,
        "internlm": InternLMForCausalLM,
        "opt": LlamaForCausalLM,
        "falcon": FalconForCausalLM,
    }
    if model_type not in registry:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported (known: "
            f"{sorted(registry)})")
    return registry[model_type]
