"""Mistral-7B.

Counterpart of vattention_tpu/model_executor/models/mistral.py: the Llama
body with sliding-window attention (window 4096 in "mistral-7b",
config.py).  The window is ModelArch data (``sliding_window``); the runner
hands it to the attention backend, and every backend (vattn, paged, POD)
applies it as a lower bound on the causal mask inside the prefill and
decode kernels: query position q attends keys p with q - window < p <= q.
The JAX package applies it on its vattn backend only (ROADMAP Queue 3).
"""

from __future__ import annotations

from vattention_tpu_torch.model_executor.models.llama import LlamaForCausalLM


class MistralForCausalLM(LlamaForCausalLM):
    """Llama body; the sliding window comes from ModelArch and is enforced
    in the attention kernels' masks."""
