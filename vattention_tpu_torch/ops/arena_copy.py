"""Relocation-plan application inside the KV arena (kernel D,
``arena_relocate``).

Replaces ``apply_relocations`` (``_copy_kernel``) of
``vattention_tpu/ops/arena_copy.py``: move i copies KV block ``src[i]``
(``block_tokens`` arena rows) to block ``dst[i]`` in every layer, for K
and V.  The plan's order is correctness-critical -- a move's destination
holds no live data only at that point in the plan -- and CUDA blocks run
in no order.  Move m copies offset r of block ``src[m]`` to offset r of
block ``dst[m]`` in each (layer, K/V, kv head) slice, so a later move
depends on an earlier one only at the same slice and offset: the grid
cuts every slice's block offsets into chunks (``relocate_plan``), each
thread owns fixed offsets and walks the whole plan over them, and needs
no barrier.  It takes the plan in batches (``relocation_batches``), all
of a batch's loads before its stores; the result equals the sequential
plan bit for bit.

Bound on the H100: bytes (each move reads and writes block_tokens rows of
every slice once).  Source: csrc/arena_relocate.cu.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from vattention_tpu_torch.ops.cuda_build import CudaKernel, check_cuda_tensor, current_stream

_I = ctypes.c_int
ARENA_RELOCATE = CudaKernel("arena_relocate", "vattn_arena_relocate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _I, _I,
    ctypes.c_longlong, _I, _I, _I, _I, _I, _I, ctypes.c_void_p])

# the source's limits (csrc/arena_relocate.cu): threads a block, offsets a
# thread, loads a thread holds in flight in one batch, slices (gridDim.y)
RELOC_THREADS = 256
MAX_RELOC_VECS = 4
BATCH_VECS = 16
MAX_SLICES = 65535
# the plan: a block's threads, and the blocks a launch per SM below which
# a thread owns fewer offsets
RELOC_BLOCK = 256
RELOC_BLOCKS_PER_SM = 4


class RelocPlan(NamedTuple):
    """D's launch: blocks of ``threads``, ``vpt`` offsets of a block a
    thread, ``chunks`` blocks a slice (the grid is chunks x slices), and
    batches of at most ``batch`` moves."""
    vpt: int
    threads: int
    chunks: int
    batch: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def relocate_plan(num_slices: int, block_vecs: int, sms: int) -> RelocPlan:
    """D's launch over ``num_slices`` slices whose blocks are
    ``block_vecs`` 16-byte vectors, on a card of ``sms`` SMs.  A thread
    owns MAX_RELOC_VECS offsets, or 2, or 1 when more would leave fewer
    than RELOC_BLOCKS_PER_SM blocks an SM of RELOC_BLOCK threads; a
    slice's chunks are then cut even, each of the fewest whole warps that
    cover it; a batch holds BATCH_VECS // vpt moves."""
    if not 0 < num_slices <= MAX_SLICES or block_vecs <= 0:
        raise ValueError(f"arena_relocate: {num_slices} slices of "
                         f"{block_vecs}-vector blocks (slices 1 to "
                         f"{MAX_SLICES})")
    for vpt in (MAX_RELOC_VECS, 2, 1):
        chunks = _cdiv(block_vecs, RELOC_BLOCK * vpt)
        if num_slices * chunks >= RELOC_BLOCKS_PER_SM * sms:
            break
    threads = _cdiv(_cdiv(block_vecs, chunks * vpt), 32) * 32
    return RelocPlan(vpt, threads, chunks, BATCH_VECS // vpt)


def relocation_batches(src: Sequence[int], dst: Sequence[int], n_moves: int,
                       max_batch: int) -> List[Tuple[int, int]]:
    """D's cut of a plan's first ``n_moves`` moves into batches, as
    ``[start, end)`` pairs in order: a batch takes consecutive moves until
    it holds ``max_batch``, the plan ends, or the next move's src is a
    block that a move of the batch writes.  Applying each batch as all of
    its loads, then its stores in plan order, equals the moves one after
    another."""
    batches = []
    m = 0
    while m < n_moves:
        written = {dst[m]}
        end = m + 1
        while (end < n_moves and end - m < max_batch
               and src[end] not in written):
            written.add(dst[end])
            end += 1
        batches.append((m, end))
        m = end
    return batches


def arena_relocate_plain(kv_cache: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, n_moves: int,
                         block_tokens: int) -> None:
    """Plain PyTorch version: the moves one after another, in plan order."""
    bt = block_tokens
    for s, d in zip(src[:n_moves].tolist(), dst[:n_moves].tolist()):
        kv_cache[:, :, :, d * bt:(d + 1) * bt] = (
            kv_cache[:, :, :, s * bt:(s + 1) * bt].clone())


_sms: Dict[torch.device, int] = {}


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


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
            or dst.numel() != src.numel() or not 0 < block_tokens <= R):
        raise ValueError(
            f"arena_relocate: cache {tuple(kv_cache.shape)}, {n_moves} "
            f"moves of {src.numel()}, block_tokens {block_tokens}")
    if n_moves == 0:
        return
    plan = relocate_plan(L * 2 * Hkv, block_tokens * row_bytes // 16,
                         _sm_count(dev))
    ARENA_RELOCATE(kv_cache.data_ptr(), src.data_ptr(), dst.data_ptr(),
                   n_moves, L * 2 * Hkv, R, row_bytes, block_tokens, *plan,
                   current_stream())
