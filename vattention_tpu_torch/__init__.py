"""vattention_tpu_torch: the PyTorch/CUDA port of vattention_tpu.

The same serving engine -- a vAttention-style contiguous KV arena, the
sarathi chunked-prefill scheduler, llama-family models -- written in
PyTorch for one NVIDIA H100, with the attention, KV-append and arena
relocation kernels hand-written in CUDA (``csrc/``, built at first use).
It imports neither JAX nor ``vattention_tpu``.
"""

__version__ = "0.1.0"

from vattention_tpu_torch.core.datatypes.request_output import RequestOutput
from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams

__all__ = ["SamplingParams", "RequestOutput", "LLMEngine", "EngineArgs"]


def __getattr__(name):
    # lazy: importing the package does not import the engine
    if name == "LLMEngine":
        from vattention_tpu_torch.engine.llm_engine import LLMEngine

        return LLMEngine
    if name == "EngineArgs":
        from vattention_tpu_torch.engine.arg_utils import EngineArgs

        return EngineArgs
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
