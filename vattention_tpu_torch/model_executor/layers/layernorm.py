"""RMSNorm (counterpart of vattention_tpu/model_executor/layers/layernorm.py)
and Falcon's LayerNorm (``layer_norm`` of
vattention_tpu/model_executor/models/falcon.py).

Plain torch: each computes in float32 and casts back, as the JAX versions
do.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a bias over the last axis: mean and (biased)
    variance in float32, then ``* weight + bias`` and a cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)
