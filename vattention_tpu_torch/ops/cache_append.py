"""KV append into the contiguous arena (kernel A, ``kv_append``).

Replaces ``cache_append_tokens`` (``_rmw_batch_kernel``) and
``cache_append_run`` (``_rmw_run_kernel``) of
``vattention_tpu/ops/cache_append.py`` with ONE launch per layer over all
of a step's tokens: token t's K/V rows go to arena row ``rows[t]``, and
``-1`` skips the token.  Rows are distinct within a step, so the kernel
stores each row once -- the TPU's 32-row read-modify-write windows,
``serialize`` and WINDOW padding have no counterpart, and the prefill
run table (``pre_runs``) is not needed.  The kernel also converts the
model's K/V (float32 or bfloat16) to the arena's dtype, folding in the
quantization the JAX backend runs in XLA before its append kernels: e4m3
arenas get ``flush_fp8_subnormals`` (saturating at +-448), int8 arenas
``quantize_int8`` by ``kv_scale`` (``ops/utils.py``).

Bound on the H100: bytes (each valid token's 2*Hkv*D elements are read
once in the model's dtype and written once in the arena's).  Design:
csrc/kv_append.cu -- one block per (token, K/V), 16-byte vector stores
along each destination row.
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, KV_DTYPE_CODES,
                                                 KV_DTYPES, CudaKernel,
                                                 check_cuda_tensor,
                                                 current_stream)
from vattention_tpu_torch.ops.utils import quantize_kv

KV_APPEND = CudaKernel("kv_append", "vattn_kv_append", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p])


def kv_append_plain(kv_cache: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, rows: torch.Tensor, layer: int,
                    kv_scale: float | None = None) -> None:
    """Plain PyTorch version: the same conversion (``quantize_kv``) and
    scatter with advanced indexing."""
    keep = rows >= 0
    r = rows[keep].long()
    for i, x in enumerate((k, v)):
        kv_cache[layer, i][:, r] = quantize_kv(
            x[keep], kv_cache.dtype, kv_scale).transpose(0, 1)


def kv_append(kv_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rows: torch.Tensor, layer: int,
              kv_scale: float | None = None) -> None:
    """Write K/V rows into the arena in place.

    kv_cache: [L, 2, Hkv, R, D]; k, v: [T, Hkv, D] of the model's dtype
    (float32 or bfloat16), converted to the arena's: its own dtype, e4m3,
    or int8 in steps of ``kv_scale``; rows: [T] int32 destination arena
    rows (-1 skips).  CPU tensors take the plain version; CUDA tensors
    launch kernel A.
    """
    if (kv_cache.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError(f"kv_append: kv_scale {kv_scale} for a "
                         f"{kv_cache.dtype} arena (int8 arenas need one)")
    if not kv_cache.is_cuda:
        kv_append_plain(kv_cache, k, v, rows, layer, kv_scale)
        return
    L, two, Hkv, R, D = kv_cache.shape
    T = k.shape[0]
    dev = kv_cache.device
    check_cuda_tensor("kv_cache", kv_cache)
    check_cuda_tensor("k", k, None, dev)
    check_cuda_tensor("v", v, k.dtype, dev)
    check_cuda_tensor("rows", rows, torch.int32, dev)
    if kv_cache.dtype not in KV_DTYPES.get(k.dtype, ()):
        raise ValueError(f"kv_append: {k.dtype} K/V into a {kv_cache.dtype} "
                         "arena")
    if (k.shape != (T, Hkv, D) or v.shape != k.shape or rows.shape != (T,)
            or two != 2 or D % 16 or not 0 <= layer < L):
        raise ValueError(
            f"kv_append shapes: cache {tuple(kv_cache.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, rows "
            f"{tuple(rows.shape)}, layer {layer}")
    if T == 0:
        return
    KV_APPEND(kv_cache.data_ptr(), k.data_ptr(), v.data_ptr(),
              rows.data_ptr(), T, Hkv, D, R, layer, DTYPE_CODES[k.dtype],
              KV_DTYPE_CODES[kv_cache.dtype], float(kv_scale or 0.0),
              current_stream())
