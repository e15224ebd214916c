"""Batched decode attention over the contiguous KV arena (kernel C,
``decode_attention``).

Replaces ``flash_decode`` (``_decode_kernel``) of
``vattention_tpu/ops/flash_decode.py``: slot b's query token (``[Hq, D]``)
attends its arena rows for positions ``[0, seqlens[b])`` -- under a
sliding ``window``, ``[max(0, seqlens[b] - window), seqlens[b])``, the JAX
kernel's ``kv_pos >= kv_len - window`` -- position p at row ``tile_rows[b,
p // sub] + p % sub``.  Slots with ``seqlens[b] == 0`` give zeros, never
NaN.  The TPU devices (``seq_tile``, ``kv_fetch``,
static kv-tile grids and their buckets) have no counterpart: the kernel
loops to each slot's live depth.

Bound on the H100: bytes (each live K/V row is read once; ~2G FLOPs per
byte).  Any group G = Hq/Hkv: the body takes a kv head's query heads in
chunks of ``chunk_width(G)`` (G rounded up to 1, 2, 4 or 8, at most 8, the
N of its tensor-core tile), each chunk a head of the split plan
(``plan_heads``), so Falcon-7B's 71 heads on one kv head are 9 chunks.
Design: csrc/decode_attention.cu, its body in
decode_attention.cuh (shared with kernel F): one launch of a fixed grid
(``decode_grid``: twice the SM count, whatever the table's depth); every
block plans the splits over the slots' live depths from ``seqlens`` on
the device (tiles of ``DECODE_TILE`` positions, at least
``MIN_SPLIT_TILES`` per split; under a window only the tiles from the one
holding ``seqlens[b] - window``, so the window, not the depth, sizes the
plan), streams K/V tiles through per-warp
cp.async rings into tensor-core products (bf16; float32 on the CUDA
cores), and the last split of each (slot, head) merges the splits inside
the launch.  The wrapper reads nothing back from the device, so a call
can be captured in a CUDA graph.  One call of the wrapper is one launch
of kernel C.  A 1-byte arena (e4m3 or int8) streams through the rings at
one byte per element and is widened exactly in the kernel; the plain
version widens the gathered rows with ``.float()``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, KV_DTYPE_CODES,
                                                 CudaKernel,
                                                 check_cuda_tensor,
                                                 check_kv_cache,
                                                 current_stream)

P, I = ctypes.c_void_p, ctypes.c_int
DECODE_ATTENTION = CudaKernel("decode_attention", "vattn_decode_attention", [
    P, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_longlong, I,
    ctypes.c_float, I, I, I, I, I, P])

KERNEL_HEAD_DIM = 128
# the decode body's chunk widths: a group of G query heads per kv head goes
# through the tensor cores in chunks of chunk_width(G) heads
CHUNK_WIDTHS = (1, 2, 4, 8)
# the split plan of csrc/decode_attention.cuh; the serving path takes the
# defaults, a sweep (``microbenchmarks/bench_decode_kernel.py``) passes
# others to ``decode_attention``
DECODE_TILE = 64        # positions per tile
MIN_SPLIT_TILES = 4     # a split's least tiles
BLOCKS_PER_SM = 2       # the grid: this many blocks per SM
MAX_SLOTS = 1024        # batch limit of the plan's prefix in shared memory
MAX_GRID = 1024         # grid limit (a merge's weights in shared memory)

# per-device split scratch and (slot, head) ticket counters of the
# in-launch merge, shared by kernels C and F: each launch leaves the
# counters at 0, so one buffer serves every layer and step.  Both kernels
# launch on the current stream and the engine uses one, so no two launches
# that share it run at once.
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_grid: Dict[Tuple[torch.device, int], int] = {}


def chunk_width(group: int) -> int:
    """The decode body's chunk width for ``group`` heads per kv head: the
    group rounded up to 1, 2, 4 or 8, at most 8 (csrc/decode_attention.cuh
    ``chunk_width``)."""
    return next((c for c in CHUNK_WIDTHS if c >= group), CHUNK_WIDTHS[-1])


def plan_heads(hkv: int, group: int) -> int:
    """The (kv head, chunk) pairs the decode plan splits: ``hkv *
    cdiv(group, chunk_width(group))`` (Falcon-7B: 1 * 9)."""
    return hkv * -(-group // chunk_width(group))


def window_arg(window) -> int:
    """The kernels' window argument: 0 for no window (None or 0), else the
    window in positions."""
    if window is None or window == 0:
        return 0
    if window < 0:
        raise ValueError(f"sliding window {window} < 0")
    return int(window)


def gather_rows(tile_rows_b: torch.Tensor, n: int, sub: int,
                start: int = 0) -> torch.Tensor:
    """Arena rows of positions [start, n) from one sequence's row table."""
    pos = torch.arange(start, n, device=tile_rows_b.device)
    return tile_rows_b.long()[pos // sub] + pos % sub


def decode_attention_plain(q, kv_cache, tile_rows, seqlens, layer: int, *,
                           sub: int, sm_scale: float,
                           window=None) -> torch.Tensor:
    """Plain PyTorch version: per slot, gather the live rows (the last
    ``window`` under a window) and run a full float32 softmax."""
    B, Hq, D = q.shape
    Hkv = kv_cache.shape[2]
    G = Hq // Hkv
    window = window_arg(window)
    out = torch.zeros_like(q)
    for b, n in enumerate(seqlens.tolist()):
        if n <= 0:
            continue
        rows = gather_rows(tile_rows[b], n, sub,
                           max(0, n - window) if window else 0)
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
    check_kv_cache(kv_cache, q.dtype, dev)
    check_cuda_tensor("tile_rows", tile_rows, torch.int32, dev)
    check_cuda_tensor("seqlens", seqlens, torch.int32, dev)
    if (q.dtype not in DTYPE_CODES or D != KERNEL_HEAD_DIM or Dc != D
            or not Hkv or Hq % Hkv or Hq < Hkv
            or tile_rows.dim() != 2 or tile_rows.shape[0] != B
            or seqlens.shape != (B,) or B > MAX_SLOTS
            or not 0 <= layer < L or sub <= 0):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} {q.dtype}, cache "
            f"{tuple(kv_cache.shape)}, tile_rows {tuple(tile_rows.shape)}, "
            f"seqlens {tuple(seqlens.shape)} (head dim {KERNEL_HEAD_DIM}, "
            f"Hkv dividing Hq, at most {MAX_SLOTS} slots)")


def decode_grid(device: torch.device,
                blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of kernel C's grid (and of F's decode role) on ``device``:
    ``blocks_per_sm`` per SM, whatever the depth of the tables, at most
    MAX_GRID.  Cached per (device, blocks_per_sm)."""
    if blocks_per_sm < 1:
        raise ValueError(f"blocks_per_sm {blocks_per_sm} < 1")
    grid = _grid.get((device, blocks_per_sm))
    if grid is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = _grid[device, blocks_per_sm] = min(blocks_per_sm * sms,
                                                  MAX_GRID)
    return grid


def decode_scratch(device: torch.device, batch: int, hkv: int, group: int,
                   grid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partials, tickets) for one launch of C's body: float32 room for
    ``grid + batch * H`` split partials of ``C * (D + 2)`` floats rounded up
    to 16 bytes, with C = chunk_width(group) and H = plan_heads(hkv, group)
    (the plan makes at most that many ranges), and ``batch * H`` int32
    counters at 0, grown when a launch needs more."""
    per_part = -(-chunk_width(group) * (KERNEL_HEAD_DIM + 2) // 4) * 4
    heads = batch * plan_heads(hkv, group)
    floats = (grid + heads) * per_part
    part, tickets = _scratch.get(device, (None, None))
    if part is None or part.numel() < floats or tickets.numel() < heads:
        part = torch.empty(max(floats, 1), dtype=torch.float32,
                           device=device)
        tickets = torch.zeros(max(heads, 64), dtype=torch.int32,
                              device=device)
        _scratch[device] = (part, tickets)
    return part, tickets


def current_scratch(device: torch.device):
    """The (partials, tickets) pair launches on ``device`` use now, or None.
    A CUDA graph keeps the pair it captured alive: a later, larger batch
    replaces the pair here but never frees the graph's."""
    return _scratch.get(device)


def decode_attention(q, kv_cache, tile_rows, seqlens, layer: int, *,
                     sub: int, sm_scale: float, window=None,
                     min_split_tiles: int = MIN_SPLIT_TILES,
                     blocks_per_sm: int = BLOCKS_PER_SM) -> torch.Tensor:
    """q: [B, Hq, D]; kv_cache: [L, 2, Hkv, R, D]; tile_rows: [B, n_sub]
    int32; seqlens: [B] int32, each at most n_sub * sub; window: the
    sliding window (None or 0: none) -> [B, Hq, D] in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch kernel C once.
    ``min_split_tiles`` and ``blocks_per_sm`` are the split plan's (the
    serving path leaves them at their defaults); the plain version has no
    plan and ignores them."""
    if min_split_tiles < 1:
        raise ValueError(f"min_split_tiles {min_split_tiles} < 1")
    if not q.is_cuda:
        return decode_attention_plain(q, kv_cache, tile_rows, seqlens,
                                      layer, sub=sub, sm_scale=sm_scale,
                                      window=window)
    check_decode_args("decode_attention", q, kv_cache, tile_rows, seqlens,
                      layer, sub)
    B, Hq, D = q.shape
    Hkv, R = kv_cache.shape[2], kv_cache.shape[3]
    out = torch.empty_like(q)
    if B == 0:
        return out
    G = Hq // Hkv
    grid = decode_grid(q.device, blocks_per_sm)
    part, tickets = decode_scratch(q.device, B, Hkv, G, grid)
    DECODE_ATTENTION(q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(),
                     part.data_ptr(), tickets.data_ptr(),
                     tile_rows.data_ptr(), seqlens.data_ptr(), B, Hkv, G,
                     tile_rows.shape[1], sub, R, layer, float(sm_scale),
                     window_arg(window), grid, int(min_split_tiles),
                     DTYPE_CODES[q.dtype],
                     KV_DTYPE_CODES[kv_cache.dtype], current_stream())
    return out
