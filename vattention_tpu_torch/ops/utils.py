"""Host-side helpers shared by the port's kernels and backend.

The PyTorch port's counterparts of ``vattention_tpu/ops/utils.py``'s host
helpers (``cdiv``, ``round_up``, ``select_kv_tile``,
``tile_rows_from_segments``) and its finite mask value, and the plain
versions of the KV quantization that kernel A folds into its stores
(``flush_fp8_subnormals`` and ``quantize_int8``, the JAX backend's
``_flush_fp8_subnormals`` and ``_quantize_int8``) and of the widening the
attention kernels apply to 1-byte K/V tiles (``widen_kv``).  The TPU-only
pieces of that module (VMEM limits, grid buckets, the packed fp8 widening
and its row permutation, in-kernel segment walks) have no counterpart
here: every 1-byte widening in the port is exact.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# |x| below this would store as an e4m3 denormal (largest denormal 7*2^-9;
# the midpoint to the least normal 2^-6 is 15*2^-10): flushed to zero
FP8_SUBNORMAL_CUTOFF = 15.0 * 2.0 ** -10
FP8_MAX = 448.0
INT8_CLIP = 127


def flush_fp8_subnormals(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or bfloat16) as e4m3: zero where |x| < the cutoff,
    then rounded to nearest even, saturating at +-448 (where the JAX
    package's ``astype`` gives NaN past 464).  The clamp makes the
    saturation explicit: PyTorch's own cast of an overflow gives NaN in
    some releases and 448 in others."""
    x = torch.where(x.float().abs() < FP8_SUBNORMAL_CUTOFF,
                    torch.zeros((), dtype=x.dtype), x)
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def quantize_int8(x: torch.Tensor, kv_scale: float) -> torch.Tensor:
    """``clip(round(x / kv_scale), -127, 127)`` as int8: a true float32
    division and round half to even, as ``jnp.round``."""
    q = torch.round(x.float() / torch.tensor(kv_scale, dtype=torch.float32))
    return torch.clamp(q, -INT8_CLIP, INT8_CLIP).to(torch.int8)


def quantize_kv(x: torch.Tensor, dtype: torch.dtype,
                kv_scale: float | None = None) -> torch.Tensor:
    """``x`` as the arena stores it: e4m3 flushed and saturated, int8
    scaled by ``kv_scale``, float32 and bfloat16 cast."""
    if dtype == torch.float8_e4m3fn:
        return flush_fp8_subnormals(x)
    if dtype == torch.int8:
        return quantize_int8(x, kv_scale)
    return x.to(dtype)


def pad_heads(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """Zero-pad the head dim to the arena's 128-aligned width (zeros are
    score-neutral)."""
    D = x.shape[-1]
    return x if D == Dp else torch.nn.functional.pad(x, (0, Dp - D))


def widen_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1-byte K/V to the compute dtype (exact for every finite e4m3
    pattern and every int8 value)."""
    return x.to(dtype)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def select_kv_tile(block_tokens: int, preferred: int = 512) -> int:
    """Largest tile <= ``preferred`` that divides the allocator's
    block_tokens, so tiles never straddle extent boundaries (extents are
    block-aligned)."""
    t = min(block_tokens, preferred)
    while block_tokens % t != 0:
        t -= 1
    return max(t, 1)


def tile_rows_from_segments(seg_row: np.ndarray, seg_cum: np.ndarray,
                            sub: int, n_sub: int) -> np.ndarray:
    """Arena-row table of sub-tile starts.

    ``seg_row [B, S]``: arena row where extent j starts; ``seg_cum
    [B, S+1]``: cumulative tokens before extent j.  Returns ``[B, n_sub]``
    int32: the arena row of token position ``s*sub`` for each sub-tile s
    (0 for positions beyond the mapped extents, which no kernel reads).
    ``sub`` must divide the allocator's block_tokens; position p then lives
    at row ``table[b, p // sub] + p % sub``.
    """
    pos = (np.arange(n_sub, dtype=np.int64) * sub)[None, :]      # [1, n]
    cum = seg_cum.astype(np.int64)
    # extent index for each position: last j with cum[j] <= pos
    j = np.maximum((pos[..., None] >= cum[:, None, :-1]).sum(-1) - 1, 0)
    rows = (np.take_along_axis(seg_row.astype(np.int64), j, 1)
            + pos - np.take_along_axis(cum[:, :-1], j, 1))
    rows = np.where(pos < cum[:, -1:], rows, 0)
    return rows.astype(np.int32)
