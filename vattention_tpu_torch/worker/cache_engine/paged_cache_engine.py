"""Paged (block-table) cache engine, the A/B baseline.

Counterpart of ``vattention_tpu/worker/cache_engine/paged_cache_engine.py``.
A pool of small blocks (16-256 tokens) on the device with per-sequence
block tables, stored like the vattn arena: ``[L, 2, Hkv, num_blocks *
block_size + block_size, Dp]`` (the extra block is the scratch block; Dp is
the head dim rounded up to 128), of the vattn arena's dtype.  Block ``b``
holds rows ``[b*bs, (b+1)*bs)``; the paged kernels address it through the
tables.  The free list, tables, slot map and OOM message are the JAX
engine's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vattention_tpu_torch.config import SystemConfig
from vattention_tpu_torch.core.datatypes.sequence import SequenceMetadata
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.ops.utils import cdiv
from vattention_tpu_torch.parallel.sharding import ShardLayout, kv_cache_shape
from vattention_tpu_torch.worker.cache_engine.base_cache_engine import (
    BaseCacheEngine, arena_dtype)

logger = init_logger(__name__)


class PagedCacheEngine(BaseCacheEngine):
    kind = "paged"

    def __init__(self, config: SystemConfig, device: torch.device):
        super().__init__(config)
        model_config = config.model_config
        cache_config = config.cache_config
        parallel_config = config.parallel_config
        self.device = device
        # the arena's dtype, as the vattn arena's (A/B runs quantize both)
        self.dtype, self.kv_scale = arena_dtype(config)
        self.num_layers = model_config.get_num_layers(parallel_config)
        self.num_kv_heads = model_config.get_num_kv_heads(parallel_config)
        self.head_size = model_config.get_head_size()
        self.head_size_padded = -(-self.head_size // 128) * 128
        self.block_size = cache_config.block_size
        self.max_batch_size = cache_config.max_batch_size

        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        kv_bytes_per_block = (2 * self.num_layers * self.num_kv_heads
                              * self.head_size_padded * self.block_size
                              * itemsize)
        if cache_config.memory_for_gpu is None:
            raise ValueError("profile memory before creating the cache engine")
        self.num_blocks = max(
            1, cache_config.memory_for_gpu // kv_bytes_per_block)
        self.max_blocks_per_seq = cdiv(model_config.max_model_len,
                                       self.block_size)
        R = self.num_blocks * self.block_size
        logger.info("paged pool: %d blocks of %d tokens (%.2f GB)",
                    self.num_blocks, self.block_size,
                    self.num_blocks * kv_bytes_per_block / 2**30)
        # extra block of rows: scratch target for padding-token scatters
        self.scratch_row = R
        # this rank's pool: the stage's layers and the tp shard's kv heads
        self.kv_cache = torch.zeros(
            kv_cache_shape(model_config.get_total_num_layers(),
                           model_config.arch.num_kv_heads,
                           R + self.block_size, self.head_size_padded,
                           ShardLayout.of_config(parallel_config)),
            dtype=self.dtype, device=device)
        self.free_blocks: List[int] = list(range(self.num_blocks))
        self.tables: Dict[str, List[int]] = {}
        self.batch_idx: Dict[str, int] = {}
        self.free_slots = list(range(self.max_batch_size - 1, -1, -1))
        # geometry shared with the attention backend
        self.block_tokens = self.block_size
        self.table_width = self.max_blocks_per_seq

    # ------------------------------------------------------------------ #
    def _seq_len_for_step(self, meta: SequenceMetadata) -> int:
        seq = meta.seq
        if meta.is_prompt:
            return (seq.get_num_prompt_tokens_processed()
                    + meta.prompt_chunk_len)
        return seq.get_len()

    def step(self, seq_metadata_list: List[SequenceMetadata]) -> None:
        for meta in seq_metadata_list:
            if meta.seq_id not in self.batch_idx:
                if not self.free_slots:
                    raise RuntimeError("no free batch slot")
                self.batch_idx[meta.seq_id] = self.free_slots.pop()
                self.tables[meta.seq_id] = []
            table = self.tables[meta.seq_id]
            needed = cdiv(self._seq_len_for_step(meta), self.block_size)
            while len(table) < needed:
                if not self.free_blocks:
                    raise RuntimeError(
                        "***** OOM on demand: paged pool exhausted *****")
                table.append(self.free_blocks.pop())

    def slot_of(self, seq_id: str) -> int:
        return self.batch_idx[seq_id]

    def get_batch_segments(self):
        """(block_table [B, NB] block ids, tokens per block [B, NB])."""
        B, NB = self.max_batch_size, self.max_blocks_per_seq
        table = np.zeros((B, NB), np.int32)
        ntok = np.zeros((B, NB), np.int32)
        for seq_id, blocks in self.tables.items():
            slot = self.batch_idx[seq_id]
            table[slot, :len(blocks)] = blocks
            ntok[slot, :len(blocks)] = self.block_size
        return table, ntok

    def get_slot_rows(self, slot: int, start_pos: int, n: int) -> np.ndarray:
        seq_id = next(s for s, i in self.batch_idx.items() if i == slot)
        blocks = np.asarray(self.tables[seq_id], np.int64)
        pos = np.arange(start_pos, start_pos + n)
        return (blocks[pos // self.block_size] * self.block_size
                + pos % self.block_size).astype(np.int32)

    def free_seq(self, seq_id: str) -> None:
        idx = self.batch_idx.pop(seq_id, None)
        if idx is not None:
            self.free_slots.append(idx)
            self.free_blocks.extend(self.tables.pop(seq_id, []))

    def on_step_completion(
            self, seq_metadata_list: List[SequenceMetadata]) -> None:
        for meta in seq_metadata_list:
            if meta.seq.is_finished():
                self.free_seq(meta.seq_id)

    def get_free_blocks(self) -> int:
        return len(self.free_blocks)

    def cleanup(self) -> None:
        self.kv_cache = None
        self.tables.clear()
