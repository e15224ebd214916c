"""Host-side helpers shared by the port's kernels and backend.

The PyTorch port's counterparts of ``vattention_tpu/ops/utils.py``'s host
helpers (``cdiv``, ``round_up``, ``select_kv_tile``,
``tile_rows_from_segments``) and its finite mask value.  The TPU-only
pieces of that module (VMEM limits, grid buckets, fp8 widening, in-kernel
segment walks) have no counterpart here.
"""

from __future__ import annotations

import numpy as np

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


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
