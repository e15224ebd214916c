"""KV append into the contiguous arena (kernel A, ``kv_append``).

Replaces ``cache_append_tokens`` (``_rmw_batch_kernel``) and
``cache_append_run`` (``_rmw_run_kernel``) of
``vattention_tpu/ops/cache_append.py`` with ONE launch per layer over all
of a step's tokens: token t's K/V rows go to arena row ``rows[t]``, and
``-1`` skips the token.  Rows are distinct within a step, so the kernel
stores each row once -- the TPU's 32-row read-modify-write windows,
``serialize`` and WINDOW padding have no counterpart, and the prefill
run table (``pre_runs``) is not needed.

Bound on the H100: bytes (each valid token's 2*Hkv*D elements are read
and written once).  Design: csrc/kv_append.cu -- one block per
(token, K/V), 16-byte vector stores along each destination row.
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import CudaKernel, check_cuda_tensor, current_stream

KV_APPEND = CudaKernel("kv_append", "vattn_kv_append", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p])


def kv_append_plain(kv_cache: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, rows: torch.Tensor, layer: int) -> None:
    """Plain PyTorch version: the same scatter with advanced indexing."""
    keep = rows >= 0
    r = rows[keep].long()
    kv_cache[layer, 0][:, r] = k[keep].to(kv_cache.dtype).transpose(0, 1)
    kv_cache[layer, 1][:, r] = v[keep].to(kv_cache.dtype).transpose(0, 1)


def kv_append(kv_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rows: torch.Tensor, layer: int) -> None:
    """Write K/V rows into the arena in place.

    kv_cache: [L, 2, Hkv, R, D]; k, v: [T, Hkv, D] of the arena's dtype;
    rows: [T] int32 destination arena rows (-1 skips).  CPU tensors take
    the plain version; CUDA tensors launch kernel A.
    """
    if not kv_cache.is_cuda:
        kv_append_plain(kv_cache, k, v, rows, layer)
        return
    L, two, Hkv, R, D = kv_cache.shape
    T = k.shape[0]
    dev = kv_cache.device
    check_cuda_tensor("kv_cache", kv_cache)
    check_cuda_tensor("k", k, kv_cache.dtype, dev)
    check_cuda_tensor("v", v, kv_cache.dtype, dev)
    check_cuda_tensor("rows", rows, torch.int32, dev)
    row_bytes = D * kv_cache.element_size()
    if (k.shape != (T, Hkv, D) or v.shape != k.shape or rows.shape != (T,)
            or two != 2 or row_bytes % 16 or not 0 <= layer < L):
        raise ValueError(
            f"kv_append shapes: cache {tuple(kv_cache.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, rows "
            f"{tuple(rows.shape)}, layer {layer}")
    if T == 0:
        return
    KV_APPEND(kv_cache.data_ptr(), k.data_ptr(), v.data_ptr(),
              rows.data_ptr(), T, Hkv, row_bytes, R, layer,
              current_stream())
