"""vATTN cache engine: flat device arena + extent allocator.

Counterpart of ``vattention_tpu/worker/cache_engine/vattn_cache_engine.py``.
Owns the arena tensor ``[L, 2, Hkv, R + block_tokens, Dp]`` on the device
(row R is the scratch row; Dp is the head dim rounded up to 128) in the
model's dtype, or e4m3 or int8 under ``kv_quant`` (``arena_dtype``: 1-byte
elements, so a page holds twice the tokens of a bf16 arena), maps
sequences to batch slots through the allocator (the native C++ core by
default, as the JAX package's auto default takes it whenever it is built;
``use_native_allocator=False`` takes the Python one), calls
``step_async`` once per iteration, and applies any relocation plan in
place through kernel D (``ops/arena_copy.arena_relocate``) before the
step's forward pass, on the same stream.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import SequenceMetadata
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.memory.allocator import VAttentionAllocator
from vattention_tpu_torch.memory.native import NativeVAttentionAllocator
from vattention_tpu_torch.model_executor.attention import AttentionBackend
from vattention_tpu_torch.ops.arena_copy import arena_relocate
from vattention_tpu_torch.worker.cache_engine.base_cache_engine import (
    BaseCacheEngine, arena_dtype)

logger = init_logger(__name__)


class VAttnCacheEngine(BaseCacheEngine):
    kind = "vattn"

    def __init__(self, config: SystemConfig, device: torch.device):
        super().__init__(config)
        model_config = config.model_config
        cache_config = config.cache_config
        parallel_config = config.parallel_config
        self.device = device
        self.dtype, self.kv_scale = arena_dtype(config)
        self.num_layers = model_config.get_num_layers(parallel_config)
        self.num_kv_heads = model_config.get_num_kv_heads(parallel_config)
        self.head_size = model_config.get_head_size()
        # head dim zero-padded to a multiple of 128 (zeros are
        # score-neutral; the backend slices the padding off its output)
        self.head_size_padded = -(-self.head_size // 128) * 128
        self.max_batch_size = cache_config.max_batch_size
        backend = AttentionBackend.resolve(model_config.attention_backend)
        self.sync_mode = AttentionBackend.is_sync(backend)

        # None and True take the native core; a core that does not build
        # raises (the JAX package warns and falls back)
        if cache_config.use_native_allocator is False:
            self.allocator = VAttentionAllocator()
        else:
            self.allocator = NativeVAttentionAllocator()
        self.allocator.init_kvcache(
            num_layers=self.num_layers,
            num_kv_heads=self.num_kv_heads,
            head_size=self.head_size_padded,
            max_batch_size=self.max_batch_size,
            max_context_length=model_config.max_model_len,
            dtype_bytes=torch.tensor([], dtype=self.dtype).element_size(),
            page_size=cache_config.page_size,
            megacache=AttentionBackend.is_megacache(backend)
            or cache_config.megacache,
        )
        if cache_config.memory_for_gpu is None:
            raise ValueError("profile memory before creating the cache engine")
        num_pages = self.allocator.reserve_physical_pages(
            cache_config.memory_for_gpu)
        self.block_tokens = self.allocator.block_tokens
        self.table_width = self.allocator.max_segments
        R = self.allocator.arena_tokens
        logger.info(
            "vATTN arena: %d KV blocks (%d pages, %d tokens/block, "
            "%d arena rows, %.2f GB)", self.allocator.num_arena_blocks,
            num_pages, self.block_tokens, R,
            self.allocator.num_arena_blocks
            * self.allocator.kvblock_bytes / 2**30)
        # one extra block of rows past the arena: the scratch row R
        self.scratch_row = max(R, 1)
        self.kv_cache = torch.zeros(
            (model_config.get_total_num_layers(), 2,
             model_config.arch.num_kv_heads,
             self.scratch_row + self.block_tokens, self.head_size_padded),
            dtype=self.dtype, device=device)
        # seq_id -> batch slot
        self.batch_idx: Dict[str, int] = {}
        self.pending_moves = 0  # telemetry

    # ------------------------------------------------------------------ #
    def _seq_len_for_step(self, meta: SequenceMetadata) -> int:
        seq = meta.seq
        if meta.is_prompt:
            return seq.get_num_prompt_tokens_processed() + meta.prompt_chunk_len
        return seq.get_len()

    def step(self, seq_metadata_list: List[SequenceMetadata]) -> None:
        for meta in seq_metadata_list:
            if meta.seq_id in self.batch_idx:
                continue
            idx = self.allocator.alloc_new_batch_idx(
                self._seq_len_for_step(meta))
            if idx == -1:
                raise RuntimeError(
                    "no free batch slot (scheduler over-admitted)")
            self.batch_idx[meta.seq_id] = idx

        seq_lens = self.allocator.seq_lens.copy()
        for meta in seq_metadata_list:
            seq_lens[self.batch_idx[meta.seq_id]] = self._seq_len_for_step(meta)

        if self.sync_mode:
            plan = self.allocator.step_sync(seq_lens)
        else:
            plan = self.allocator.step_async(seq_lens)
        if plan:
            self._apply_plan(plan)

    def _apply_plan(self, plan) -> None:
        """Run the plan's ordered block moves in place (kernel D).  The
        move tables go to the card from pinned memory without a host wait,
        so a relocation does not stall the async engine."""
        n = len(plan.moves)
        # src and dst in one copy, each row 16-byte aligned
        moves = torch.zeros((2, -(-n // 4) * 4), dtype=torch.int32)
        moves[0, :n] = torch.tensor([mv.src for mv in plan.moves])
        moves[1, :n] = torch.tensor([mv.dst for mv in plan.moves])
        if self.device.type == "cuda":
            moves = moves.pin_memory().to(self.device, non_blocking=True)
        arena_relocate(self.kv_cache, moves[0], moves[1], n,
                       self.block_tokens)
        self.pending_moves += n

    # ------------------------------------------------------------------ #
    def slot_of(self, seq_id: str) -> int:
        return self.batch_idx[seq_id]

    def get_batch_segments(self):
        return self.allocator.get_batch_segments()

    def get_slot_rows(self, slot: int, start_pos: int, n: int) -> np.ndarray:
        """Arena rows for token positions [start_pos, start_pos+n)."""
        rows = np.empty(n, np.int32)
        seg_row, seg_tok = self.allocator.get_batch_segments()
        cum = 0
        filled = 0
        for j in range(self.allocator.max_segments):
            length = int(seg_tok[slot, j])
            lo, hi = cum, cum + length
            a = max(start_pos, lo)
            b = min(start_pos + n, hi)
            if a < b:
                base = int(seg_row[slot, j])
                rows[a - start_pos:b - start_pos] = (
                    base + np.arange(a - lo, b - lo, dtype=np.int32))
                filled += b - a
            cum = hi
        if filled != n:
            raise RuntimeError(
                f"positions beyond mapped extents ({filled} != {n})")
        return rows

    def free_seq(self, seq_id: str) -> None:
        idx = self.batch_idx.pop(seq_id, None)
        if idx is not None:
            self.allocator.free_batch_idx(idx)

    def on_step_completion(
            self, seq_metadata_list: List[SequenceMetadata]) -> None:
        for meta in seq_metadata_list:
            if meta.seq.is_finished():
                self.free_seq(meta.seq_id)

    def get_free_blocks(self) -> int:
        return int(self.allocator.num_free_kvblocks())

    def cleanup(self) -> None:
        self.allocator.cleanup()
        self.kv_cache = None
