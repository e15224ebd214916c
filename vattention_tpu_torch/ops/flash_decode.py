"""Batched decode attention over the contiguous KV arena (kernel C,
``decode_attention``).

Replaces ``flash_decode`` (``_decode_kernel``) of
``vattention_tpu/ops/flash_decode.py``: slot b's query token (``[Hq, D]``)
attends its arena rows for positions ``[0, seqlens[b])``, position p at
row ``tile_rows[b, p // sub] + p % sub``.  Slots with ``seqlens[b] == 0``
give zeros, never NaN.  The TPU devices (``seq_tile``, ``kv_fetch``,
static kv-tile grids and their buckets) have no counterpart: the kernel
loops to each slot's live depth.

Bound on the H100: bytes (each live K/V row is read once; ~1 FMA per
byte).  Design: csrc/decode_attention.cu, its body in
decode_attention.cuh (shared with kernel F) -- split over positions
(flash-decoding) so that 8 slots still fill the card: pass 1 runs one
block per (slot, kv head, split of SPLIT_POSITIONS positions) covering
the G query heads of the group, 8 warps splitting the positions, online
softmax per head in float32 registers; pass 2 merges the splits.  One
call of the wrapper is one launch of kernel C (both passes).
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, CudaKernel,
                                                 check_cuda_tensor,
                                                 current_stream)
from vattention_tpu_torch.ops.utils import cdiv

DECODE_ATTENTION = CudaKernel("decode_attention", "vattn_decode_attention", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = (1, 2, 4, 8)
SPLIT_POSITIONS = 256  # positions per pass-1 block


def gather_rows(tile_rows_b: torch.Tensor, n: int, sub: int) -> torch.Tensor:
    """Arena rows of positions [0, n) from one sequence's row table."""
    pos = torch.arange(n, device=tile_rows_b.device)
    return tile_rows_b.long()[pos // sub] + pos % sub


def decode_attention_plain(q, kv_cache, tile_rows, seqlens, layer: int, *,
                           sub: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version: per slot, gather the live rows and run a full
    float32 softmax."""
    B, Hq, D = q.shape
    Hkv = kv_cache.shape[2]
    G = Hq // Hkv
    out = torch.zeros_like(q)
    for b, n in enumerate(seqlens.tolist()):
        if n <= 0:
            continue
        rows = gather_rows(tile_rows[b], n, sub)
        k = kv_cache[layer, 0][:, rows].float()           # [Hkv, n, D]
        v = kv_cache[layer, 1][:, rows].float()
        qf = q[b].float().reshape(Hkv, G, D)
        p = torch.softmax(torch.einsum("hgd,hkd->hgk", qf, k) * sm_scale, -1)
        out[b] = torch.einsum("hgk,hkd->hgd", p, v).reshape(Hq, D).to(q.dtype)
    return out


def check_decode_args(name, q, kv_cache, tile_rows, seqlens, layer: int,
                      sub: int) -> None:
    """Raise unless kernel C's body (kernels C and F) takes these
    arguments."""
    B, Hq, D = q.shape
    L, two, Hkv, R, Dc = kv_cache.shape
    dev = q.device
    check_cuda_tensor("q", q)
    check_cuda_tensor("kv_cache", kv_cache, q.dtype, dev)
    check_cuda_tensor("tile_rows", tile_rows, torch.int32, dev)
    check_cuda_tensor("seqlens", seqlens, torch.int32, dev)
    if (q.dtype not in DTYPE_CODES or D != KERNEL_HEAD_DIM or Dc != D
            or Hq % Hkv or Hq // Hkv not in KERNEL_GROUPS
            or tile_rows.dim() != 2 or tile_rows.shape[0] != B
            or seqlens.shape != (B,) or not 0 <= layer < L or sub <= 0):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} {q.dtype}, cache "
            f"{tuple(kv_cache.shape)}, tile_rows {tuple(tile_rows.shape)}, "
            f"seqlens {tuple(seqlens.shape)} (head dim {KERNEL_HEAD_DIM}, "
            f"groups {KERNEL_GROUPS})")


def split_count(tile_rows: torch.Tensor, sub: int) -> int:
    """Pass-1 splits per (slot, head): enough for the table's depth."""
    return max(1, cdiv(tile_rows.shape[1] * sub, SPLIT_POSITIONS))


def decode_attention(q, kv_cache, tile_rows, seqlens, layer: int, *,
                     sub: int, sm_scale: float) -> torch.Tensor:
    """q: [B, Hq, D]; kv_cache: [L, 2, Hkv, R, D]; tile_rows: [B, n_sub]
    int32; seqlens: [B] int32, each at most n_sub * sub -> [B, Hq, D] in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    kernel C."""
    if not q.is_cuda:
        return decode_attention_plain(q, kv_cache, tile_rows, seqlens,
                                      layer, sub=sub, sm_scale=sm_scale)
    check_decode_args("decode_attention", q, kv_cache, tile_rows, seqlens,
                      layer, sub)
    B, Hq, D = q.shape
    Hkv, R = kv_cache.shape[2], kv_cache.shape[3]
    out = torch.empty_like(q)
    if B == 0:
        return out
    G = Hq // Hkv
    n_sub = tile_rows.shape[1]
    nsplit = split_count(tile_rows, sub)
    part = torch.empty(B * Hkv * nsplit * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    DECODE_ATTENTION(q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(),
                     part.data_ptr(), tile_rows.data_ptr(),
                     seqlens.data_ptr(), B, Hkv, G, n_sub, sub, R, layer,
                     float(sm_scale), SPLIT_POSITIONS, nsplit,
                     DTYPE_CODES[q.dtype], current_stream())
    return out
