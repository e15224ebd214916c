"""Activations (counterpart of vattention_tpu/model_executor/layers/activation.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """x: [..., 2*I] -> silu(x[..., :I]) * x[..., I:] (silu in float32)."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate.float()).to(x.dtype) * up
