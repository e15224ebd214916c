"""Relocation-plan application inside the KV arena (kernel D,
``arena_relocate``).

Replaces ``apply_relocations`` (``_copy_kernel``) of
``vattention_tpu/ops/arena_copy.py``: move i copies KV block ``src[i]``
(``block_tokens`` arena rows) to block ``dst[i]`` in every layer, for K
and V.  The plan's order is correctness-critical -- a move's destination
holds no live data only at that point in the plan -- and CUDA blocks run
in no order, so each block owns one (layer, K/V, kv head) slice and walks
every move in plan order with a barrier between moves.  Slices are
disjoint, so the result equals the sequential plan bit for bit.

Bound on the H100: bytes (each move reads and writes block_tokens rows of
every slice once).  Source: csrc/arena_relocate.cu.
"""

from __future__ import annotations

import ctypes

import torch

from vattention_tpu_torch.ops.cuda_build import CudaKernel, check_cuda_tensor, current_stream

ARENA_RELOCATE = CudaKernel("arena_relocate", "vattn_arena_relocate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


def arena_relocate_plain(kv_cache: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, n_moves: int,
                         block_tokens: int) -> None:
    """Plain PyTorch version: the moves one after another, in plan order."""
    bt = block_tokens
    for s, d in zip(src[:n_moves].tolist(), dst[:n_moves].tolist()):
        kv_cache[:, :, :, d * bt:(d + 1) * bt] = (
            kv_cache[:, :, :, s * bt:(s + 1) * bt].clone())


def arena_relocate(kv_cache: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, n_moves: int,
                   block_tokens: int) -> None:
    """Apply the first ``n_moves`` block moves of a plan, in place.

    kv_cache: [L, 2, Hkv, R, D]; src, dst: [M >= n_moves] int32 block
    indices.  CPU tensors take the plain version; CUDA tensors launch
    kernel D.
    """
    if not kv_cache.is_cuda:
        arena_relocate_plain(kv_cache, src, dst, n_moves, block_tokens)
        return
    L, two, Hkv, R, D = kv_cache.shape
    dev = kv_cache.device
    check_cuda_tensor("kv_cache", kv_cache)
    check_cuda_tensor("src", src, torch.int32, dev)
    check_cuda_tensor("dst", dst, torch.int32, dev)
    row_bytes = D * kv_cache.element_size()
    if (two != 2 or row_bytes % 16 or not 0 <= n_moves <= src.numel()
            or dst.numel() != src.numel() or block_tokens <= 0):
        raise ValueError(
            f"arena_relocate: cache {tuple(kv_cache.shape)}, {n_moves} "
            f"moves of {src.numel()}, block_tokens {block_tokens}")
    if n_moves == 0:
        return
    ARENA_RELOCATE(kv_cache.data_ptr(), src.data_ptr(), dst.data_ptr(),
                   n_moves, L * 2 * Hkv, R, row_bytes, block_tokens,
                   current_stream())
