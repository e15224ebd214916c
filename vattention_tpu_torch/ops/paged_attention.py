"""Paged (block-table) attention, the A/B baseline (kernel E,
``paged_prefill_attention``; kernel H, ``paged_prefill_attention_single``;
and kernel C over block tables).

Replaces ``paged_flash_prefill_multi``, ``paged_flash_prefill`` and
``paged_flash_decode`` of ``vattention_tpu/ops/paged_attention.py``.  The
pool has the arena's layout ``[L, 2, Hkv, R, D]`` with ``R = num_blocks *
block_size`` (plus one scratch block); block ``b`` holds pool rows
``[b*bs, (b+1)*bs)``.

Prefill (kernel E): the q region holds K runs as for kernel B
(``ops/flash_prefill.py``), and key position p of run r lives at row
``block_tables[r, min(p // bs, cdiv(kv_len, bs) - 1)] * bs + p % bs``.
E is kernel B's body (csrc/prefill_attention.cuh) with that lookup in
place of B's row table, as the JAX kernel reuses ``_prefill_kernel``; only
positions below kv_len are loaded, so a table's tail past the run's last
valid block is never read.  Bound on the H100: operations, as B.
Kernel H is E for one run through one block table (``qinfo = (q_start,
kv_len)``, no ``qt_run``), as ``paged_flash_prefill`` is the single-run
form; it equals E bit for bit on one run.

Sliding windows: E, H and the paged decode take ``window`` as kernels B
and C do.  The JAX paged kernels take none (the JAX runner builds its
paged backend without the model's window), so on a windowed model the JAX
fa_paged engine attends past the window; the port applies it on every
backend, as ``models/mistral.py`` of both packages says (ROADMAP Queue 3).

Decode: a block table is a row table at ``sub = block_size``, so
``paged_decode_attention`` builds ``table * block_size`` with each entry
clamped to the slot's last valid block (``paged_tile_rows``, JAX
``paged_attention.py:235-247``) and calls kernel C.

The pool may be 1-byte (e4m3 or int8), as the arena (``ops/flash_prefill.py``).

Dropped TPU devices: ``kv_fetch`` and ``PAGED_WIDE_TILE`` (E's key tile
does not depend on the block size), ``max_kv_tiles`` and its buckets (the
kernels loop to each run's or slot's live depth).
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, KV_DTYPE_CODES,
                                                 CudaKernel, current_stream)
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_decode import window_arg
from vattention_tpu_torch.ops.flash_prefill import (
    causal_prefill_plain, check_prefill_args, check_prefill_shapes,
    single_run_plain)

PAGED_PREFILL_ATTENTION = CudaKernel(
    "paged_prefill_attention", "vattn_paged_prefill_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

PAGED_PREFILL_SINGLE = CudaKernel(
    "paged_prefill_attention", "vattn_paged_prefill_single", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])


def block_rows(table: torch.Tensor, n: int, block_size: int) -> torch.Tensor:
    """Pool rows of positions [0, n) from one block table."""
    pos = torch.arange(n, device=table.device)
    return table.long()[pos // block_size] * block_size + pos % block_size


def paged_prefill_attention_plain(q, kv_cache, qt_run, qinfo, block_tables,
                                  layer: int, *, block_size: int,
                                  pad_tile: int, sm_scale: float,
                                  window=None) -> torch.Tensor:
    """Plain PyTorch version of kernel E."""
    return causal_prefill_plain(
        q, kv_cache, qt_run, qinfo,
        lambda run, n: block_rows(block_tables[run], n, block_size), layer,
        pad_tile=pad_tile, sm_scale=sm_scale, window=window)


def paged_prefill_attention(q, kv_cache, qt_run, qinfo, block_tables,
                            layer: int, *, block_size: int, pad_tile: int,
                            sm_scale: float, window=None) -> torch.Tensor:
    """q: [Tq, Hq, D] with Tq % pad_tile == 0; kv_cache: [L, 2, Hkv, R, D];
    qt_run: [Tq // pad_tile, 2], qinfo: [K, 2] (q_start, kv_len),
    block_tables: [K, NB] block ids (int32); window: the sliding window
    (None or 0: none) -> [Tq, Hq, D] in q's dtype.  CPU tensors take the
    plain version; CUDA tensors launch kernel E."""
    if not q.is_cuda:
        return paged_prefill_attention_plain(
            q, kv_cache, qt_run, qinfo, block_tables, layer,
            block_size=block_size, pad_tile=pad_tile, sm_scale=sm_scale,
            window=window)
    check_prefill_args("paged_prefill_attention", q, kv_cache, qt_run, qinfo,
                       block_tables, layer, pad_tile, block_size)
    Tq, Hq, _ = q.shape
    _, _, Hkv, R, _ = kv_cache.shape
    out = torch.empty_like(q)
    if Tq == 0:
        return out
    PAGED_PREFILL_ATTENTION(
        q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(), qt_run.data_ptr(),
        qinfo.data_ptr(), block_tables.data_ptr(), Tq, Hq, Hkv, pad_tile,
        block_tables.shape[1], block_size, R, layer, float(sm_scale),
        window_arg(window), DTYPE_CODES[q.dtype],
        KV_DTYPE_CODES[kv_cache.dtype], current_stream())
    return out


def paged_prefill_attention_single_plain(q, kv_cache, block_table, qinfo,
                                         layer: int, *, block_size: int,
                                         sm_scale: float,
                                         window=None) -> torch.Tensor:
    """Plain PyTorch version of kernel H."""
    return single_run_plain(
        q, kv_cache, qinfo,
        lambda run, n: block_rows(block_table, n, block_size), layer,
        sm_scale=sm_scale, window=window)


def paged_prefill_attention_single(q, kv_cache, block_table, qinfo,
                                   layer: int, *, block_size: int,
                                   sm_scale: float,
                                   window=None) -> torch.Tensor:
    """q: [Tq, Hq, D], one chunk at positions ``qinfo[0] + [0, Tq)``;
    kv_cache: [L, 2, Hkv, R, D]; block_table: [NB] block ids, qinfo: [2] =
    (q_start, kv_len) (int32); window: the sliding window (None or 0:
    none) -> [Tq, Hq, D] in q's dtype.  CPU tensors take the plain version;
    CUDA tensors launch kernel H."""
    if not q.is_cuda:
        return paged_prefill_attention_single_plain(
            q, kv_cache, block_table, qinfo, layer, block_size=block_size,
            sm_scale=sm_scale, window=window)
    check_prefill_shapes(
        "paged_prefill_attention_single", q, kv_cache, layer, None,
        qinfo.shape == (2,) and block_table.dim() == 1
        and block_table.numel() > 0 and block_size > 0,
        block_table=block_table, qinfo=qinfo)
    Tq, Hq, _ = q.shape
    _, _, Hkv, R, _ = kv_cache.shape
    out = torch.empty_like(q)
    if Tq == 0:
        return out
    PAGED_PREFILL_SINGLE(
        q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(),
        block_table.data_ptr(), block_table.shape[0], block_size,
        qinfo.data_ptr(), Tq, Hq, Hkv, R, layer, float(sm_scale),
        window_arg(window), DTYPE_CODES[q.dtype],
        KV_DTYPE_CODES[kv_cache.dtype], current_stream())
    return out


def paged_tile_rows(block_table: torch.Tensor, seqlens: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """[B, NB] block ids and [B] depths -> [B, NB] int32 row table for
    kernel C at ``sub = block_size``: entry j is ``table[b, min(j, last)] *
    block_size``, with ``last`` the slot's last valid block (at least
    block 0), so no entry past a slot's blocks is used."""
    B, NB = block_table.shape
    nb_valid = torch.clamp((seqlens.long() + block_size - 1) // block_size,
                           min=1)
    idx = torch.minimum(
        torch.arange(NB, device=block_table.device)[None, :],
        nb_valid[:, None] - 1)
    return (torch.gather(block_table.long(), 1, idx)
            * block_size).to(torch.int32)


def paged_decode_attention(q, kv_cache, block_table, seqlens, layer: int, *,
                           block_size: int, sm_scale: float,
                           window=None) -> torch.Tensor:
    """q: [B, Hq, D]; block_table: [B, NB] block ids; seqlens: [B] (each
    at most NB * block_size); window: the sliding window (None or 0: none)
    -> [B, Hq, D].  Kernel C over the clamped row table (its plain version
    on CPU tensors)."""
    depth = int(seqlens.max()) if seqlens.numel() else 0
    if depth > block_table.shape[1] * block_size:
        raise ValueError(
            f"paged_decode_attention: depth {depth} exceeds "
            f"the table's {block_table.shape[1]} blocks of {block_size}")
    rows = paged_tile_rows(block_table, seqlens, block_size)
    return decode_attention(q, kv_cache, rows, seqlens, layer,
                            sub=block_size, sm_scale=sm_scale, window=window)

