"""Activations (counterpart of vattention_tpu/model_executor/layers/activation.py).

Plain torch, as the JAX versions are plain jnp that XLA fuses into the
step."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """x: [..., 2*I] -> silu(x[..., :I]) * x[..., I:] (silu in float32)."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate.float()).to(x.dtype) * up


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Falcon's MLP activation: GELU with the tanh approximation, computed
    in float32 and cast back (the JAX ``gelu_new``)."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)
