"""POD attention: a mixed step's prefill runs and decode batch in one
launch (kernel F, ``pod_attention``).

Replaces ``pod_fused_attention`` (``_pod_kernel``) of
``vattention_tpu/ops/pod_fused.py``.  The prefill part takes what kernel B
takes (``ops/flash_prefill.py``: K runs padded to ``pad_tile``,
``qt_run``, ``qinfo``, the runs' arena-row tables) and the decode part
what kernel C takes (``ops/flash_decode.py``: one query token per slot,
the slots' row tables, ``seqlens``), and one sliding ``window`` for both;
both outputs are returned, and they equal B's and C's on the same inputs.
The JAX kernel takes no window (its backend drops the model's), so on a
windowed model the JAX fa_pod engine attends past the window; F applies
it, as the vattn backend does (ROADMAP Queue 3).

Dropped TPU devices: ``build_pod_schedule`` (the host weave handed to the
kernel by scalar prefetch) -- F's blocks find their role from their own
index, prefill blocks first (a bf16 block fills an SM, so a decode block
woven ahead of a prefill block would only delay it); ``POD_KV_LEN_LIMIT`` (a Mosaic scratch-memory fault
of the TPU kernel) -- F loops to each run's live depth as B does; the
manual double-buffered decode DMAs -- blocks of both roles share the SMs
instead.

Bound on the H100: operations at serving depth (the prefill part's
tensor-core work), with the decode part's bytes beside it.  Design:
csrc/pod_attention.cu -- one grid of B's prefill blocks, then C's grid
(``decode_grid``) running C's body: the same split plan over the live
depths, and the same merge inside the launch (the last split of each slot
and head to finish merges), so a mixed step attends through one launch
per layer.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, KV_DTYPE_CODES,
                                                 CudaKernel, current_stream)
from vattention_tpu_torch.ops.flash_decode import (check_decode_args,
                                                   decode_attention_plain,
                                                   decode_grid,
                                                   decode_scratch, window_arg)
from vattention_tpu_torch.ops.flash_prefill import (check_prefill_args,
                                                    prefill_attention_plain)

P, I = ctypes.c_void_p, ctypes.c_int
POD_ATTENTION = CudaKernel("pod_attention", "vattn_pod_attention", [
    P, P, P, P, P, P, P, P, P, P, I, P, I, P, I, I, I, I, I, I,
    ctypes.c_longlong, I, ctypes.c_float, I, I, I, I, P])


def pod_attention_plain(q_prefill, q_decode, kv_cache, qt_run, qinfo,
                        pre_tile_rows, dec_tile_rows, dec_seqlens,
                        layer: int, *, sub: int, pad_tile: int,
                        sm_scale: float, window=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel F: kernel B's plain version, then
    kernel C's, on the same inputs."""
    out_p = prefill_attention_plain(q_prefill, kv_cache, qt_run, qinfo,
                                    pre_tile_rows, layer, sub=sub,
                                    pad_tile=pad_tile, sm_scale=sm_scale,
                                    window=window)
    out_d = decode_attention_plain(q_decode, kv_cache, dec_tile_rows,
                                   dec_seqlens, layer, sub=sub,
                                   sm_scale=sm_scale, window=window)
    return out_p, out_d


def pod_attention(q_prefill, q_decode, kv_cache, qt_run, qinfo,
                  pre_tile_rows, dec_tile_rows, dec_seqlens, layer: int, *,
                  sub: int, pad_tile: int, sm_scale: float, window=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_prefill: [Tq, Hq, D] (Tq % pad_tile == 0) with qt_run
    [Tq // pad_tile, 2], qinfo [K, 2] and pre_tile_rows [K, n_sub];
    q_decode: [B, Hq, D] with dec_tile_rows [B, n_sub'] and dec_seqlens
    [B] (int32); kv_cache: [L, 2, Hkv, R, D]; window: the sliding window of
    both parts (None or 0: none) -> (prefill out [Tq, Hq, D], decode out
    [B, Hq, D]) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch kernel F."""
    args = (q_prefill, q_decode, kv_cache, qt_run, qinfo, pre_tile_rows,
            dec_tile_rows, dec_seqlens, layer)
    if not q_prefill.is_cuda:
        return pod_attention_plain(*args, sub=sub, pad_tile=pad_tile,
                                   sm_scale=sm_scale, window=window)
    check_prefill_args("pod_attention", q_prefill, kv_cache, qt_run, qinfo,
                       pre_tile_rows, layer, pad_tile, sub)
    check_decode_args("pod_attention", q_decode, kv_cache, dec_tile_rows,
                      dec_seqlens, layer, sub)
    Tq, Hq, D = q_prefill.shape
    B = q_decode.shape[0]
    _, _, Hkv, R, _ = kv_cache.shape
    if q_decode.dtype != q_prefill.dtype or q_decode.shape[1:] != (Hq, D):
        raise ValueError(
            f"pod_attention: q_decode {tuple(q_decode.shape)} "
            f"{q_decode.dtype} against q_prefill {tuple(q_prefill.shape)} "
            f"{q_prefill.dtype}")
    out_p = torch.empty_like(q_prefill)
    out_d = torch.empty_like(q_decode)
    if Tq == 0 and B == 0:
        return out_p, out_d
    G = Hq // Hkv
    dev = q_prefill.device
    n_dec = decode_grid(dev) if B else 0
    part, tickets = decode_scratch(dev, B, Hkv, G, n_dec)
    POD_ATTENTION(
        q_prefill.data_ptr(), q_decode.data_ptr(), kv_cache.data_ptr(),
        out_p.data_ptr(), out_d.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), qt_run.data_ptr(), qinfo.data_ptr(),
        pre_tile_rows.data_ptr(), pre_tile_rows.shape[1],
        dec_tile_rows.data_ptr(), dec_tile_rows.shape[1],
        dec_seqlens.data_ptr(), Tq, B, Hkv, G, sub, pad_tile, R, layer,
        float(sm_scale), window_arg(window), n_dec,
        DTYPE_CODES[q_prefill.dtype],
        KV_DTYPE_CODES[kv_cache.dtype], current_stream())
    return out_p, out_d
