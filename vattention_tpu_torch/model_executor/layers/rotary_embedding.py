"""Rotary position embeddings with scaling variants.

Counterpart of ``vattention_tpu/model_executor/layers/rotary_embedding.py``:
non-interleaved (rotate-half) RoPE, HF-Llama convention, with linear,
dynamic-NTK and YaRN scaling.  cos/sin are computed from the positions in
float32 on the positions' device; q/k are rotated in float32 and cast
back, as in the JAX version.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch


class RotaryEmbedding:
    def __init__(self, head_dim: int, rotary_dim: int, max_position: int,
                 base: float):
        self.head_dim = head_dim
        self.rotary_dim = rotary_dim
        self.max_position = max_position
        self.base = base
        self.inv_freq = torch.from_numpy(
            self._compute_inv_freq(base).astype(np.float32))

    def _compute_inv_freq(self, base: float) -> np.ndarray:
        return 1.0 / (base ** (
            np.arange(0, self.rotary_dim, 2, dtype=np.float32)
            / self.rotary_dim))

    def _cos_sin(self, positions: torch.Tensor):
        inv_freq = self.inv_freq.to(positions.device)
        freqs = positions.float()[:, None] * inv_freq[None, :]
        return torch.cos(freqs), torch.sin(freqs)

    def _rotate(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        xr = x[..., :self.rotary_dim].float()
        x1, x2 = xr.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
        if self.rotary_dim < x.shape[-1]:
            out = torch.cat([out, x[..., self.rotary_dim:]], dim=-1)
        return out

    def __call__(self, positions: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor):
        """positions: [T]; q: [T, Hq, D]; k: [T, Hkv, D]."""
        cos, sin = self._cos_sin(positions)  # [T, rot/2]
        cos = cos[:, None, :]
        sin = sin[:, None, :]
        return self._rotate(q, cos, sin), self._rotate(k, cos, sin)


class LinearScalingRotaryEmbedding(RotaryEmbedding):
    def __init__(self, head_dim, rotary_dim, max_position, base, factor):
        self.factor = factor
        super().__init__(head_dim, rotary_dim, max_position, base)

    def _cos_sin(self, positions):
        return super()._cos_sin(positions.float() / self.factor)


class DynamicNTKScalingRotaryEmbedding(RotaryEmbedding):
    """NTK-aware scaling: rebase theta by the context-stretch factor."""

    def __init__(self, head_dim, rotary_dim, max_position, base, factor):
        self.factor = factor
        adjusted = base * (
            (factor * max_position / max_position) - (factor - 1)
        ) ** (rotary_dim / (rotary_dim - 2))
        super().__init__(head_dim, rotary_dim, max_position * int(factor),
                         adjusted)


class YaRNScalingRotaryEmbedding(RotaryEmbedding):
    def __init__(self, head_dim, rotary_dim, max_position, base, factor,
                 *, beta_fast: float = 32.0, beta_slow: float = 1.0,
                 extrapolation_factor: float = 1.0, attn_factor: float = 1.0):
        self.factor = factor
        self.beta_fast = beta_fast
        self.beta_slow = beta_slow
        self.extrapolation_factor = extrapolation_factor
        self.mscale = float(
            (0.1 * math.log(factor) + 1.0) * attn_factor if factor > 1
            else 1.0)
        self.orig_max_position = max_position
        super().__init__(head_dim, rotary_dim, max_position * int(factor),
                         base)

    def _find_dim(self, num_rotations: int) -> float:
        return (self.rotary_dim * math.log(
            self.orig_max_position / (num_rotations * 2 * math.pi))
        ) / (2 * math.log(self.base))

    def _compute_inv_freq(self, base: float) -> np.ndarray:
        pos_freqs = base ** (
            np.arange(0, self.rotary_dim, 2, dtype=np.float32)
            / self.rotary_dim)
        inv_freq_extrapolation = 1.0 / pos_freqs
        inv_freq_interpolation = 1.0 / (self.factor * pos_freqs)
        low = math.floor(self._find_dim(self.beta_fast))
        high = math.ceil(self._find_dim(self.beta_slow))
        low, high = max(low, 0), min(high, self.rotary_dim - 1)
        ramp = (np.arange(self.rotary_dim // 2, dtype=np.float32) - low) / \
            max(high - low, 1e-3)
        ramp = np.clip(ramp, 0.0, 1.0)
        mask = (1.0 - ramp) * self.extrapolation_factor
        return (inv_freq_interpolation * (1 - mask)
                + inv_freq_extrapolation * mask)

    def __call__(self, positions, q, k):
        q, k = super().__call__(positions, q, k)
        return q * self.mscale, k * self.mscale


def get_rope(head_dim: int, rotary_dim: int, max_position: int, base: float,
             rope_scaling: Optional[Dict[str, Any]] = None
             ) -> RotaryEmbedding:
    if not rope_scaling:
        return RotaryEmbedding(head_dim, rotary_dim, max_position, base)
    scaling_type = rope_scaling.get("type", rope_scaling.get("rope_type"))
    factor = float(rope_scaling.get("factor", 1.0))
    if scaling_type == "linear":
        return LinearScalingRotaryEmbedding(
            head_dim, rotary_dim, max_position, base, factor)
    if scaling_type == "dynamic":
        return DynamicNTKScalingRotaryEmbedding(
            head_dim, rotary_dim, max_position, base, factor)
    if scaling_type == "yarn":
        return YaRNScalingRotaryEmbedding(
            head_dim, rotary_dim,
            rope_scaling.get("original_max_position_embeddings",
                             max_position),
            base, factor)
    # llama3-style and unknown types: plain rope, as in the JAX package
    return RotaryEmbedding(head_dim, rotary_dim, max_position, base)
