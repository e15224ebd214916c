"""Chunked causal prefill attention over the contiguous KV arena
(kernel B, ``prefill_attention``; kernel G, ``segment_prefill_attention``).

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

The kernel's own q tile is ``KERNEL_ROWS[dtype] / G`` tokens (G =
Hq/Hkv): 128/G in bfloat16, 64/G in float32; ``pad_tile`` stays the
scheduler's charge unit (config.PREFILL_TOKEN_PAD = 128), which every
group of 1, 2, 4 or 8 fits.  Dropped TPU devices: ``kv_fetch``,
``seq_tile``, static kv grids and their buckets -- the kernel walks each
q tile's keys to its causal diagonal.

Bound on the H100: operations at serving depth (4*Hq*D FLOPs per attended
(query, key) pair).  Design: csrc/prefill_attention.cuh -- a block per
(q tile, kv head) covers the G heads of one GQA group and keeps an online
float32 softmax per row.  bfloat16: two warpgroups of 64 query rows run
both products with wgmma (S and P in registers, float32 accumulate) over
K/V tiles that a producer warpgroup brings into a ring in shared memory
by cp.async; float32: the same algorithm on the CUDA cores.

Kernel G replaces ``flash_prefill`` of the same file: one run (the q
region is one chunk at positions ``q_start + [0, Tq)``, ``qinfo = (q_start,
kv_len)``), its rows resolved in the kernel from the request's extent
table (``seg_row [S]``, ``seg_cum [S+1]``, S <= 8) as ``seg_row_lookup``
does, for each key position -- so, unlike the TPU kernel, whose index map
resolves one row per sub-row tile, G takes extents that align to no tile.
G is B's body with that row map and a one-run q map (no ``qt_run``), so
it equals B bit for bit on the same rows.  The TPU options ``window`` and
``fp8_packed`` raise (ROADMAP Queue 1 items 12 and 10); ``q_tile``,
``kv_tile``, ``kv_fetch`` and ``max_kv_tiles`` have no counterpart.
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

SEGMENT_PREFILL_ATTENTION = CudaKernel(
    "prefill_attention", "vattn_segment_prefill_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

KERNEL_HEAD_DIM = 128
# query rows (token, head) per block of the CUDA body, by dtype
KERNEL_ROWS = {torch.bfloat16: 128, torch.float32: 64}
MAX_SEGMENTS = 8  # extents kernel G holds per request
PLAIN_Q_SLICE = 256  # query tokens per pass of G's and H's plain versions


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


def check_prefill_shapes(name, q, kv_cache, layer: int, q_tile, fits: bool,
                         **tables) -> None:
    """Raise unless the CUDA prefill body (kernels B, E, F, G, H) takes
    these arguments: ``q``'s tokens in tiles of ``q_tile`` (None: one
    block's, ``KERNEL_ROWS[q.dtype] / G`` tokens), ``tables`` the kernel's
    int32 tables and ``fits`` its own conditions on their shapes."""
    Tq, Hq, D = q.shape
    L, _, Hkv, _, Dc = kv_cache.shape
    check_cuda_tensor("q", q)
    check_cuda_tensor("kv_cache", kv_cache, q.dtype, q.device)
    for arg, t in tables.items():
        check_cuda_tensor(arg, t, torch.int32, q.device)
    G = Hq // Hkv if Hkv and Hq % Hkv == 0 else 0
    block = KERNEL_ROWS.get(q.dtype, 0)
    rows = block // G if G and block % G == 0 else 0
    if q_tile is None:
        q_tile = rows
    if (not fits or not block or D != KERNEL_HEAD_DIM
            or Dc != D or not rows or q_tile <= 0 or q_tile % rows
            or Tq % q_tile or not 0 <= layer < L):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} {q.dtype}, cache "
            f"{tuple(kv_cache.shape)}, "
            + ", ".join(f"{k} {tuple(t.shape)}" for k, t in tables.items())
            + f", q tile {q_tile} (head dim {KERNEL_HEAD_DIM}, q tiles of "
            f"a multiple of {block or '128 (bf16) or 64 (f32)'} / G "
            "tokens)")


def check_prefill_args(name, q, kv_cache, qt_run, qinfo, table, layer: int,
                       pad_tile: int, unit: int) -> None:
    """Raise unless the CUDA prefill kernels over K runs (B, E) take these
    arguments; ``table`` is the per-run row or block table, ``unit`` its
    rows per entry."""
    Tq = q.shape[0]
    fits = (pad_tile > 0 and qt_run.shape == (Tq // pad_tile, 2)
            and qinfo.dim() == 2 and qinfo.shape[1] == 2
            and table.dim() == 2 and table.shape[0] == qinfo.shape[0]
            and table.shape[1] > 0 and unit > 0)
    check_prefill_shapes(name, q, kv_cache, layer, pad_tile, fits,
                         qt_run=qt_run, qinfo=qinfo, table=table)


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


def reject_unported(name, kv_cache, window) -> None:
    """Raise NotImplementedError for the TPU kernels' options that the
    single-run prefill kernels (G, H) do not take yet."""
    if window is not None:
        raise NotImplementedError(
            f"{name}: sliding windows are not ported yet (ROADMAP Queue 1 "
            "item 12)")
    if kv_cache.element_size() == 1:
        raise NotImplementedError(
            f"{name}: {kv_cache.dtype} KV is not ported yet (ROADMAP Queue 1 "
            "item 10)")


def single_run_plain(q, kv_cache, qinfo, rows_of, layer: int, *,
                     sm_scale: float) -> torch.Tensor:
    """Plain PyTorch prefill of one run at positions ``qinfo[0] + [0,
    Tq)`` (``qinfo = (q_start, kv_len)``): kernels G and H's plain
    versions.  Runs ``PLAIN_Q_SLICE`` query tokens at a time over the keys
    they can see, so its float32 scores stay a few GB at depth 128K."""
    out = torch.zeros_like(q)
    q_start, kv_len = (int(x) for x in qinfo.tolist())
    qt_run = torch.zeros((1, 2), dtype=torch.int32, device=q.device)
    for a in range(0, q.shape[0], PLAIN_Q_SLICE):
        qs = q[a:a + PLAIN_Q_SLICE]
        seen = min(kv_len, q_start + a + qs.shape[0])
        info = torch.tensor([[q_start + a, seen]], dtype=torch.int32,
                            device=q.device)
        out[a:a + qs.shape[0]] = causal_prefill_plain(
            qs, kv_cache, qt_run, info, rows_of, layer, pad_tile=qs.shape[0],
            sm_scale=sm_scale)
    return out


def segment_rows(seg_row: torch.Tensor, seg_cum: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Arena rows of positions [0, n) from one extent table, as
    ``seg_row_lookup``: position p at ``seg_row[j] + p - seg_cum[j]`` for
    the last j with ``seg_cum[j] <= p < seg_cum[j+1]``, row 0 where no
    extent maps it."""
    pos = torch.arange(n, device=seg_row.device)
    cum = seg_cum.long()
    rows = torch.zeros(n, dtype=torch.long, device=seg_row.device)
    for j, row in enumerate(seg_row.long()):
        within = (pos >= cum[j]) & (pos < cum[j + 1])
        rows = torch.where(within, row + pos - cum[j], rows)
    return rows


def segment_prefill_attention_plain(q, kv_cache, seg_row, seg_cum, qinfo,
                                    layer: int, *,
                                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel G."""
    return single_run_plain(
        q, kv_cache, qinfo, lambda run, n: segment_rows(seg_row, seg_cum, n),
        layer, sm_scale=sm_scale)


def segment_prefill_attention(q, kv_cache, seg_row, seg_cum, qinfo,
                              layer: int, *, sm_scale: float,
                              window=None) -> torch.Tensor:
    """q: [Tq, Hq, D], one chunk at positions ``qinfo[0] + [0, Tq)``;
    kv_cache: [L, 2, Hkv, R, D]; seg_row: [S], seg_cum: [S+1] (S <= 8),
    qinfo: [2] = (q_start, kv_len) (int32) -> [Tq, Hq, D] in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch kernel G."""
    reject_unported("segment_prefill_attention", kv_cache, window)
    if not q.is_cuda:
        return segment_prefill_attention_plain(
            q, kv_cache, seg_row, seg_cum, qinfo, layer, sm_scale=sm_scale)
    S = seg_row.shape[0] if seg_row.dim() == 1 else 0
    check_prefill_shapes(
        "segment_prefill_attention", q, kv_cache, layer, None,
        qinfo.shape == (2,) and 0 < S <= MAX_SEGMENTS
        and seg_cum.shape == (S + 1,),
        seg_row=seg_row, seg_cum=seg_cum, qinfo=qinfo)
    Tq, Hq, _ = q.shape
    _, _, Hkv, R, _ = kv_cache.shape
    out = torch.empty_like(q)
    if Tq == 0:
        return out
    SEGMENT_PREFILL_ATTENTION(
        q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(), seg_row.data_ptr(),
        seg_cum.data_ptr(), S, qinfo.data_ptr(), Tq, Hq, Hkv, R, layer,
        float(sm_scale), DTYPE_CODES[q.dtype], current_stream())
    return out
