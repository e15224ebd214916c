"""Model registry (counterpart of vattention_tpu/model_executor/models/__init__.py).

The port has the llama-family body only; the other families raise
NotImplementedError until they are ported (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


def get_model_class(model_type: str):
    from vattention_tpu_torch.model_executor.models.yi import YiForCausalLM

    registry = {
        "llama": LlamaForCausalLM,
        "yi": YiForCausalLM,
        "opt": LlamaForCausalLM,
    }
    if model_type not in registry:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    return registry[model_type]
