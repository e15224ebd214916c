"""RMSNorm (counterpart of vattention_tpu/model_executor/layers/layernorm.py).

Plain torch: computes in float32 and casts back, as the JAX version does.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)
