"""Chunked causal prefill attention over the contiguous KV arena
(kernel B, ``prefill_attention``).

Replaces ``flash_prefill_multi`` (``_prefill_kernel``) of
``vattention_tpu/ops/flash_prefill.py``: the q region ``[Tq, Hq, D]``
holds K prefill runs, each padded to ``pad_tile`` rows;
``qt_run[i] = (run, local tile)`` for each pad_tile-row tile and
``qinfo[run] = (q_start, kv_len)``.  Token j of local tile lt sits at
position ``q_start + lt*pad_tile + j`` (not ``positions[]``, which is 0 on
padding rows) and attends positions ``p <= its own`` with ``p < kv_len``,
read from the arena at row ``tile_rows[run, p // sub] + p % sub``.  The
chunk's own K/V must already be in the arena (kernel A runs first).
Tiles whose run has ``kv_len == 0`` -- the empty run that fixed-width
padding maps tail tiles to -- give zeros.

The kernel's own q tile is 64/G tokens (G = Hq/Hkv); ``pad_tile`` stays
the scheduler's charge unit (config.PREFILL_TOKEN_PAD = 128).  Dropped
TPU devices: ``kv_fetch``, ``seq_tile``, static kv grids and their
buckets -- the kernel walks each q tile's keys to its causal diagonal.

Bound on the H100: operations at serving depth (4*Hq*D FLOPs per attended
(query, key) pair).  Design: csrc/prefill_attention.cu -- a block per
(q tile, kv head) covers the G heads of one GQA group, stages K/V tiles
in shared memory and keeps an online float32 softmax per row; bfloat16
runs both products on the tensor cores (WMMA, float32 accumulate),
float32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, CudaKernel,
                                                 check_cuda_tensor,
                                                 current_stream)
from vattention_tpu_torch.ops.flash_decode import gather_rows

PREFILL_ATTENTION = CudaKernel(
    "prefill_attention", "vattn_prefill_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])

KERNEL_HEAD_DIM = 128
KERNEL_ROWS = 64  # query rows (token, head) per block


def causal_prefill_plain(q, kv_cache, qt_run, qinfo, rows_of, layer: int, *,
                         pad_tile: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch prefill over K runs: per run, gather the rows
    ``rows_of(run, kv_len)`` of its positions [0, kv_len) and run a full
    float32 causal softmax.  Shared by kernels B and E's plain versions."""
    Tq, Hq, D = q.shape
    Hkv = kv_cache.shape[2]
    G = Hq // Hkv
    out = torch.zeros_like(q)
    qt_run = qt_run.long()
    local = torch.arange(pad_tile, device=q.device)
    for run in torch.unique(qt_run[:, 0]).tolist():
        q_start, kv_len = (int(x) for x in qinfo[run].tolist())
        if kv_len <= 0:
            continue
        tiles = torch.nonzero(qt_run[:, 0] == run)[:, 0]
        tok = (tiles[:, None] * pad_tile + local[None, :]).reshape(-1)
        q_pos = (q_start + qt_run[tiles, 1][:, None] * pad_tile
                 + local[None, :]).reshape(-1)
        rows = rows_of(run, kv_len)
        k = kv_cache[layer, 0][:, rows].float()           # [Hkv, kv_len, D]
        v = kv_cache[layer, 1][:, rows].float()
        qf = q[tok].float().reshape(-1, Hkv, G, D)
        s = torch.einsum("thgd,hkd->hgtk", qf, k) * sm_scale
        kv_pos = torch.arange(kv_len, device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]),
                          float("-inf"))
        o = torch.einsum("hgtk,hkd->thgd", torch.softmax(s, -1), v)
        out[tok] = o.reshape(-1, Hq, D).to(q.dtype)
    return out


def check_prefill_args(name, q, kv_cache, qt_run, qinfo, table, layer: int,
                       pad_tile: int, unit: int) -> None:
    """Raise unless the CUDA prefill kernels (B, E) take these arguments;
    ``table`` is the per-run row or block table, ``unit`` its rows per
    entry."""
    Tq, Hq, D = q.shape
    L, two, Hkv, R, Dc = kv_cache.shape
    dev = q.device
    for arg, t in (("qt_run", qt_run), ("qinfo", qinfo), ("table", table)):
        check_cuda_tensor(arg, t, torch.int32, dev)
    check_cuda_tensor("q", q)
    check_cuda_tensor("kv_cache", kv_cache, q.dtype, dev)
    G = Hq // Hkv if Hkv and Hq % Hkv == 0 else 0
    if (q.dtype not in DTYPE_CODES or D != KERNEL_HEAD_DIM or Dc != D
            or G == 0 or KERNEL_ROWS % G or pad_tile % (KERNEL_ROWS // G)
            or Tq % pad_tile or qt_run.shape != (Tq // pad_tile, 2)
            or qinfo.dim() != 2 or qinfo.shape[1] != 2
            or table.dim() != 2 or table.shape[0] != qinfo.shape[0]
            or table.shape[1] == 0 or not 0 <= layer < L or unit <= 0):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} {q.dtype}, cache "
            f"{tuple(kv_cache.shape)}, qt_run {tuple(qt_run.shape)}, qinfo "
            f"{tuple(qinfo.shape)}, table {tuple(table.shape)}, "
            f"pad_tile {pad_tile}")


def prefill_attention_plain(q, kv_cache, qt_run, qinfo, tile_rows,
                            layer: int, *, sub: int, pad_tile: int,
                            sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B."""
    return causal_prefill_plain(
        q, kv_cache, qt_run, qinfo,
        lambda run, n: gather_rows(tile_rows[run], n, sub), layer,
        pad_tile=pad_tile, sm_scale=sm_scale)


def prefill_attention(q, kv_cache, qt_run, qinfo, tile_rows, layer: int, *,
                      sub: int, pad_tile: int,
                      sm_scale: float) -> torch.Tensor:
    """q: [Tq, Hq, D] with Tq % pad_tile == 0; kv_cache: [L, 2, Hkv, R, D];
    qt_run: [Tq // pad_tile, 2], qinfo: [K, 2], tile_rows: [K, n_sub]
    (int32) -> [Tq, Hq, D] in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch kernel B."""
    if not q.is_cuda:
        return prefill_attention_plain(q, kv_cache, qt_run, qinfo,
                                       tile_rows, layer, sub=sub,
                                       pad_tile=pad_tile, sm_scale=sm_scale)
    check_prefill_args("prefill_attention", q, kv_cache, qt_run, qinfo,
                       tile_rows, layer, pad_tile, sub)
    Tq, Hq, _ = q.shape
    _, _, Hkv, R, _ = kv_cache.shape
    out = torch.empty_like(q)
    if Tq == 0:
        return out
    PREFILL_ATTENTION(q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(),
                      qt_run.data_ptr(), qinfo.data_ptr(),
                      tile_rows.data_ptr(), Tq, Hq, Hkv, pad_tile,
                      tile_rows.shape[1], sub, R, layer, float(sm_scale),
                      DTYPE_CODES[q.dtype], current_stream())
    return out
