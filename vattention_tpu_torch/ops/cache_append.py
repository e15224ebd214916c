"""RoPE and KV append into the contiguous arena (kernel A,
``rope_kv_append``; ``kv_append`` is the same kernel with the rotation
off).

``rope_kv_append`` takes a layer's qkv projection, rotates Q and K,
returns the rotated Q and writes the rotated K and V into the arena (or
the paged pool) in ONE launch: the JAX step's rope, which XLA fuses into
the jitted step, and its append kernels; with a qkv bias (qwen,
internlm) it adds the bias first, which XLA also fuses.  It replaces
``cache_append_tokens`` (``_rmw_batch_kernel``) and
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

Bound on the H100: bytes (each token's qkv row read once, its Q written
once, each valid token's 2*Hkv*D K/V elements written once in the arena's
dtype, the bias row read once).  Design: csrc/kv_append.cu -- one block
per token, one thread per 16-byte vector of each half of a head, the
token's cos/sin computed once per block while the loads are in flight.
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import (DTYPE_CODES, KV_DTYPE_CODES,
                                                 KV_DTYPES, CudaKernel,
                                                 check_cuda_tensor,
                                                 current_stream)
from vattention_tpu_torch.ops.utils import pad_heads, quantize_kv

ROPE_KV_APPEND = CudaKernel("kv_append", "vattn_rope_kv_append", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
KV_APPEND = CudaKernel("kv_append", "vattn_kv_append", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p])


def _check_scale(kv_cache: torch.Tensor, kv_scale) -> None:
    if (kv_cache.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError(f"kv_append: kv_scale {kv_scale} for a "
                         f"{kv_cache.dtype} arena (int8 arenas need one)")


def split_qkv(qkv: torch.Tensor, num_kv_heads: int, head_dim: int):
    """[T, (Hq + 2 Hkv) * D] -> q [T, Hq, D], k and v [T, Hkv, D] (views)."""
    T, W = qkv.shape
    q, k, v = qkv.view(T, W // head_dim, head_dim).split(
        [W // head_dim - 2 * num_kv_heads, num_kv_heads,
         num_kv_heads], dim=1)
    return q, k, v


def rope_kv_append_plain(kv_cache: torch.Tensor, qkv: torch.Tensor,
                         positions: torch.Tensor, rows: torch.Tensor,
                         layer: int, rope, kv_scale: float | None = None,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``qkv + bias`` (if any), ``rope`` on q and
    k, then ``kv_append_plain`` of k and v zero-padded to the arena's head
    width."""
    if bias is not None:
        qkv = qkv + bias
    q, k, v = split_qkv(qkv, kv_cache.shape[2], rope.head_dim)
    q, k = rope(positions, q, k)
    Dp = kv_cache.shape[-1]
    kv_append_plain(kv_cache, pad_heads(k, Dp), pad_heads(v, Dp), rows,
                    layer, kv_scale)
    return q


def rope_kv_append(kv_cache: torch.Tensor, qkv: torch.Tensor,
                   positions: torch.Tensor, rows: torch.Tensor, layer: int,
                   rope, kv_scale: float | None = None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate a layer's Q and K and write its K/V rows into the arena.

    kv_cache: [L, 2, Hkv, R, Dp]; qkv: [T, (Hq + 2 Hkv) * D] of the
    model's dtype (float32 or bfloat16), Q heads then K then V, with D =
    ``rope.head_dim`` <= Dp; positions, rows: [T] int32 (rows[t] = -1
    skips the token's K/V); ``rope`` a ``RotaryEmbedding`` of any variant
    rotating the whole head; ``bias`` None or the layer's qkv bias
    [(Hq + 2 Hkv) * D] of qkv's dtype, added to every row (and rounded to
    it) before the rotation.  Returns q [T, Hq, D], rotated, for every
    token.  K/V are written as ``kv_append`` writes them, zero past D.
    CPU tensors take the plain version; CUDA tensors launch kernel A.
    """
    _check_scale(kv_cache, kv_scale)
    if not kv_cache.is_cuda:
        return rope_kv_append_plain(kv_cache, qkv, positions, rows, layer,
                                    rope, kv_scale, bias)
    L, two, Hkv, R, Dp = kv_cache.shape
    D = rope.head_dim
    T = qkv.shape[0]
    Hq = qkv.shape[1] // D - 2 * Hkv
    dev = kv_cache.device
    check_cuda_tensor("kv_cache", kv_cache)
    check_cuda_tensor("qkv", qkv, None, dev)
    check_cuda_tensor("positions", positions, torch.int32, dev)
    check_cuda_tensor("rows", rows, torch.int32, dev)
    if kv_cache.dtype not in KV_DTYPES.get(qkv.dtype, ()):
        raise ValueError(f"rope_kv_append: {qkv.dtype} K/V into a "
                         f"{kv_cache.dtype} arena")
    if (qkv.dim() != 2 or qkv.shape[1] != (Hq + 2 * Hkv) * D or Hq <= 0
            or positions.shape != (T,) or rows.shape != (T,) or two != 2
            or rope.rotary_dim != D or D % 32 or D > Dp or Dp % 32
            or not 0 <= layer < L):
        raise ValueError(
            f"rope_kv_append shapes: cache {tuple(kv_cache.shape)}, qkv "
            f"{tuple(qkv.shape)}, positions {tuple(positions.shape)}, rows "
            f"{tuple(rows.shape)}, head_dim {D}, rotary_dim "
            f"{rope.rotary_dim}, layer {layer}")
    if bias is not None:
        check_cuda_tensor("bias", bias, qkv.dtype, dev)
        if bias.shape != (qkv.shape[1],):
            raise ValueError(f"rope_kv_append: bias {tuple(bias.shape)} for "
                             f"qkv {tuple(qkv.shape)}")
    q = torch.empty(T, Hq, D, dtype=qkv.dtype, device=dev)
    if T == 0:
        return q
    inv_freq, pos_scale, post_scale = rope.kernel_args(dev)
    ROPE_KV_APPEND(q.data_ptr(), kv_cache.data_ptr(), qkv.data_ptr(),
                   positions.data_ptr(), rows.data_ptr(),
                   inv_freq.data_ptr(),
                   None if bias is None else bias.data_ptr(), T, Hq, Hkv,
                   D, Dp, R, layer,
                   DTYPE_CODES[qkv.dtype], KV_DTYPE_CODES[kv_cache.dtype],
                   pos_scale, post_scale, float(kv_scale or 0.0),
                   current_stream())
    return q


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
    """Write K/V rows into the arena in place (kernel A without the
    rotation).

    kv_cache: [L, 2, Hkv, R, D]; k, v: [T, Hkv, D] of the model's dtype
    (float32 or bfloat16), converted to the arena's: its own dtype, e4m3,
    or int8 in steps of ``kv_scale``; rows: [T] int32 destination arena
    rows (-1 skips).  CPU tensors take the plain version; CUDA tensors
    launch kernel A.
    """
    _check_scale(kv_cache, kv_scale)
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
