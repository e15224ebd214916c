"""vAttention-style KV-cache allocator, re-designed for TPU HBM.

Reference semantics: vattention/vattention.cu:27-610 + vattention/utils.h.

The reference keeps each request's KV cache *virtually* contiguous with
CUDA VM APIs (cuMemAddressReserve + on-demand cuMemMap of 64KB-2MB pages).
TPUs expose no user-controllable page tables, so the TPU-native equivalent
keeps each request's KV *physically* (nearly) contiguous inside one flat
HBM arena:

  - The arena is a single preallocated buffer per layer (or a megacache
    buffer), logically divided into ``num_arena_blocks`` page-groups
    ("KV blocks", ref utils.h:8-11: one token-span across K+V+all layers).
  - Each active request owns up to ``max_segments`` contiguous *extents*
    of KV blocks whose concatenation is the request's KV in token order.
    After placement a request typically has ONE extent, so dense Pallas
    attention kernels slice ``arena[offset : offset+seqlen]`` with a
    single scalar offset -- zero block-table indirection, exactly like
    flash_attn_with_kvcache over the reference's virtually-contiguous
    slab.  Under fragmentation the extent count grows (bounded by S);
    kernels consume a tiny per-request extent table through scalar
    prefetch, so the fallback costs scalar arithmetic, not HBM gathers.
  - Growth commits the next block at the extent tail when free; otherwise
    it opens a new extent -- *no data copies on the critical path*, the
    analog of the reference's on-demand cuMemMap.  Only when a request
    exhausts its extent budget does the allocator coalesce extents with
    async device copies (a :class:`RelocationPlan` the cache engine
    overlaps with compute, like the reference's background mapper thread,
    vattention.cu:488-558).
  - Eager growth (EAGER_NUM_STEPS/EAGER_NUM_KVBLOCKS, vattention.cu:486-492)
    reserves tail blocks ahead of the decode front.
  - Deferred reclamation trims over-committed tails one block per step
    (ref do_reclaim_pages, vattention.cu:444-469), keeping freed requests'
    blocks warm for best-fit reuse by new requests
    (alloc_new_batch_idx, vattention.cu:564-589).

``max_segments=1`` gives strict whole-request contiguity (relocation
copies on every collision) for A/B comparison.

This module is pure bookkeeping (numpy arrays); it owns no device memory.
``worker/cache_engine`` owns the JAX arena buffers and applies relocation
plans on device.  A native C++ implementation of the same API lives in
``csrc/`` (see memory/native.py); this Python version is the reference
implementation and CPU-test backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)

# Heuristics, ref vattention.cu:486-487
EAGER_NUM_STEPS = 10
EAGER_NUM_KVBLOCKS = 2

DEFAULT_MAX_SEGMENTS = 8


@dataclass(frozen=True)
class Relocation:
    """Move one KV block from ``src`` to ``dst`` (block units)."""

    src: int
    dst: int


@dataclass
class RelocationPlan:
    """Ordered per-block device copies.

    The order is significant: executing moves sequentially (as a Pallas
    grid does) is always safe, because the planner only emits a move when
    its destination block holds no live data at that point in the plan.
    Per-block granularity is also the natural unit for the device-side
    copy kernel: a grid over moves, each program DMAing one page-group.
    """

    moves: List[Relocation] = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.moves)

    def __len__(self) -> int:
        return len(self.moves)


class VAttentionAllocator:
    """Singleton-style allocator (ref: vAttentionCachingAllocator)."""

    def __init__(self) -> None:
        self.is_configured = False
        self.deferred_reclaim = True
        self.verbose = False

    # ------------------------------------------------------------------ #
    # Initialization (ref: init_kvcache, vattention.cu:97-128)
    # ------------------------------------------------------------------ #
    def init_kvcache(
        self,
        num_layers: int,
        num_kv_heads: int,
        head_size: int,
        max_batch_size: int,
        max_context_length: int,
        dtype_bytes: int,
        page_size: int,
        megacache: bool = False,
        max_segments: int = DEFAULT_MAX_SEGMENTS,
    ) -> None:
        assert 0 < max_batch_size < 1000
        assert 0 < max_context_length < 1_000_000
        assert 0 < num_layers < 128
        assert 0 < num_kv_heads < 256
        assert max_segments >= 1
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_size = head_size
        self.max_batch_size = max_batch_size
        self.max_context_length = max_context_length
        self.dtype_bytes = dtype_bytes
        self.page_size = page_size
        self.megacache = megacache
        self.max_segments = max_segments

        # ref init_kv_block_size, vattention.cu:37-46
        per_token_bytes = num_kv_heads * head_size * dtype_bytes
        if megacache:
            per_token_bytes *= num_layers
        self.block_tokens = max(1, page_size // per_token_bytes)
        # round DOWN to a 32-row multiple when possible: arena rows are
        # DMA'd in sublane tiles, and a non-32-multiple block granularity
        # (e.g. 170 tokens: 256KB pages over 12x64 kv heads) would
        # misalign every tile fetch.  Mirrors the reference's page-size
        # rounding (vtensor.h:78-88); wastes <=31 tokens per page.
        if self.block_tokens > 32:
            self.block_tokens -= self.block_tokens % 32
        # pages per KV block (ref utils.h:8-11)
        self.pages_per_kvblock = 2 if megacache else 2 * num_layers
        self.kvblock_bytes = self.pages_per_kvblock * page_size

        self.max_blocks_per_req = self.tokens_to_blocks(max_context_length)

        B, S = max_batch_size, max_segments
        # per-slot state (ref utils.h:68-69 + extent placement)
        self.seq_lens = np.zeros(B, dtype=np.int64)
        self.seg_off = np.full((B, S), -1, dtype=np.int64)   # block offset
        self.seg_len = np.zeros((B, S), dtype=np.int64)      # blocks
        self.nsegs = np.zeros(B, dtype=np.int64)

        self.num_arena_blocks = 0
        self.block_owner: Optional[np.ndarray] = None  # -1 free, else slot id
        # copy-cost telemetry (block counts by cause)
        self.stats = {"coalesce": 0, "coalesce_events": 0,
                      "new_segments": 0, "repack": 0, "repack_events": 0}
        self.is_configured = True

    # derived per-slot views -------------------------------------------- #
    @property
    def mapped_blocks(self) -> np.ndarray:
        return self.seg_len.sum(axis=1)

    @property
    def run_offset(self) -> np.ndarray:
        """First-extent offset per slot (-1 when nothing mapped)."""
        return np.where(self.nsegs > 0, self.seg_off[:, 0], -1)

    def tokens_to_blocks(self, num_tokens: int) -> int:
        """ref utils.h tokens_to_pages:105-108 (block == page-group here)."""
        return int(-(-int(num_tokens) // self.block_tokens))

    def blocks_to_tokens(self, num_blocks: int) -> int:
        return int(num_blocks) * self.block_tokens

    # ------------------------------------------------------------------ #
    # Physical reservation (ref: reserve_physical_pages, cudaInternal.h:45-68)
    # ------------------------------------------------------------------ #
    def reserve_physical_pages(self, free_memory: int) -> int:
        """Size the arena to ``free_memory`` bytes; returns #pages reserved.

        ref get_num_phys_blocks (utils.h): round down to whole KV blocks.
        """
        assert self.is_configured
        num_pages = free_memory // self.page_size
        num_pages -= num_pages % self.pages_per_kvblock
        self.num_arena_blocks = int(num_pages // self.pages_per_kvblock)
        self.block_owner = np.full(self.num_arena_blocks, -1, dtype=np.int32)
        return int(num_pages)

    @property
    def arena_tokens(self) -> int:
        """Total token rows in each per-layer arena buffer."""
        return self.num_arena_blocks * self.block_tokens

    # ------------------------------------------------------------------ #
    # Accounting queries
    # ------------------------------------------------------------------ #
    def _free_block_count(self) -> int:
        return int(np.count_nonzero(self.block_owner == -1))

    def get_num_overcommitted_kvblocks(self) -> int:
        """ref utils.h get_num_overcommitted_kvblocks:176-183."""
        required = np.array(
            [self.tokens_to_blocks(s) for s in self.seq_lens], dtype=np.int64)
        return int(np.sum(self.mapped_blocks - required))

    def num_free_kvblocks(self) -> int:
        """Free pool + overcommitted tails (ref vattention.cu:206-210)."""
        return self._free_block_count() + self.get_num_overcommitted_kvblocks()

    def kvblocks_available(self, n: int) -> bool:
        return self._free_block_count() >= n

    def is_active_req(self, req_id: int) -> bool:
        return self.seq_lens[req_id] != 0

    def get_batch_token_offsets(self) -> np.ndarray:
        """Per-slot first-extent starting row in the flat arena (tokens).

        Inactive slots report 0 (their kernels are masked out).  This is
        the TPU generalization of the reference's ``cache_batch_idx``;
        single-extent requests (the common case) need nothing else.
        """
        off = self.run_offset
        off = np.where(off >= 0, off, 0)
        return (off * self.block_tokens).astype(np.int32)

    def get_batch_segments(self) -> Tuple[np.ndarray, np.ndarray]:
        """Extent tables for the kernels (scalar-prefetch metadata).

        Returns ``(seg_row, seg_tokens)``, each ``[max_batch_size, S]``
        int32: starting arena row of each extent, and the extent length in
        tokens (0 for unused extents).  Concatenated in token order.
        """
        seg_row = np.where(self.seg_off >= 0,
                           self.seg_off * self.block_tokens, 0)
        seg_tokens = self.seg_len * self.block_tokens
        return seg_row.astype(np.int32), seg_tokens.astype(np.int32)

    def num_segments(self, slot: int) -> int:
        return int(self.nsegs[slot])

    # ------------------------------------------------------------------ #
    # Free-run search
    # ------------------------------------------------------------------ #
    def _free_runs(self):
        """(starts, lengths) of maximal free runs in the arena."""
        free = self.block_owner == -1
        padded = np.concatenate(([False], free, [False]))
        diff = np.diff(padded.astype(np.int8))
        starts = np.nonzero(diff == 1)[0]
        ends = np.nonzero(diff == -1)[0]
        return starts, ends - starts

    def _find_free_run(self, n: int, spread: bool = True) -> int:
        """Contiguous free run of >= n blocks; -1 if none.

        ``spread=True`` prefers the largest adequate hole (worst fit):
        extents grow at their tails, so tight placement guarantees a
        future collision; slack maximizes in-place growth runway.
        """
        if n <= 0:
            return -1
        starts, lengths = self._free_runs()
        if len(starts) == 0:
            return -1
        ok = lengths >= n
        if not ok.any():
            return -1
        if spread:
            idx = int(np.argmax(np.where(ok, lengths, -1)))
        else:
            idx = int(np.argmin(np.where(ok, lengths,
                                         np.iinfo(np.int64).max)))
        return int(starts[idx])

    # ------------------------------------------------------------------ #
    # Extent primitives
    # ------------------------------------------------------------------ #
    def _claim(self, slot: int, start: int, n: int) -> None:
        assert (self.block_owner[start:start + n] == -1).all()
        self.block_owner[start:start + n] = slot

    def _extend_last_segment(self, slot: int, start: int, n: int) -> None:
        s = int(self.nsegs[slot]) - 1
        assert s >= 0
        assert self.seg_off[slot, s] + self.seg_len[slot, s] == start
        self._claim(slot, start, n)
        self.seg_len[slot, s] += n

    def _open_segment(self, slot: int, start: int, n: int) -> None:
        s = int(self.nsegs[slot])
        assert s < self.max_segments
        self._claim(slot, start, n)
        self.seg_off[slot, s] = start
        self.seg_len[slot, s] = n
        self.nsegs[slot] += 1
        self.stats["new_segments"] += 1

    def _release_tail_block(self, slot: int) -> None:
        """Unmap the last mapped block (ref unmap_req_page_one)."""
        s = int(self.nsegs[slot]) - 1
        assert s >= 0 and self.seg_len[slot, s] > 0
        last = int(self.seg_off[slot, s] + self.seg_len[slot, s] - 1)
        assert self.block_owner[last] == slot
        self.block_owner[last] = -1
        self.seg_len[slot, s] -= 1
        if self.seg_len[slot, s] == 0:
            self.seg_off[slot, s] = -1
            self.nsegs[slot] -= 1

    def release_kvcache_blocks_some(self, slot: int, retain: int) -> None:
        while self.mapped_blocks[slot] > retain:
            self._release_tail_block(slot)

    def release_kvcache_blocks_all(self, slot: int) -> None:
        self.release_kvcache_blocks_some(slot, 0)

    def _slot_segments(self, slot: int) -> List[Tuple[int, int]]:
        """[(offset, nblocks)] in token order."""
        return [(int(self.seg_off[slot, i]), int(self.seg_len[slot, i]))
                for i in range(int(self.nsegs[slot]))]

    def _tail_room(self, slot: int) -> int:
        """Free blocks directly after the last extent's tail."""
        if self.nsegs[slot] == 0:
            return 0
        s = int(self.nsegs[slot]) - 1
        tail = int(self.seg_off[slot, s] + self.seg_len[slot, s])
        n = 0
        while (tail + n < self.num_arena_blocks
               and self.block_owner[tail + n] == -1):
            n += 1
        return n

    # ------------------------------------------------------------------ #
    # Growth (ref grow_kvcache_phys, vattention.cu:268-323)
    # ------------------------------------------------------------------ #
    def _grow(self, slot: int, num_blocks: int, sync: bool,
              plan: RelocationPlan) -> int:
        """Grow ``slot`` by up to ``num_blocks``; returns blocks added.

        Order: in-place tail extension -> new extents (no copies) ->
        extent coalescing via device copies (budget exhausted, rare).
        ``sync=False`` (eager/background mode) only does copy-free work.
        """
        if num_blocks <= 0:
            return 0
        cur = int(self.mapped_blocks[slot])
        if cur + num_blocks > self.max_blocks_per_req:
            if not sync:
                return 0
            raise RuntimeError(
                "***** [Unexpected] request has already received max number "
                "of pages *****")  # ref is_valid_offset, vattention.cu:254-262

        if not self.kvblocks_available(num_blocks):
            if not sync:
                return 0
            self.reclaim_kvblocks_on_demand(num_blocks)
            if not self.kvblocks_available(num_blocks):
                self.verbose = True
                self.show_allocator_state()
                raise RuntimeError(
                    "***** OOM on demand: not enough free pages to continue "
                    "*****")  # ref vattention.cu:276-296

        remaining = num_blocks
        # 1) extend the last extent in place
        if self.nsegs[slot] > 0:
            room = min(self._tail_room(slot), remaining)
            if room > 0:
                s = int(self.nsegs[slot]) - 1
                tail = int(self.seg_off[slot, s] + self.seg_len[slot, s])
                self._extend_last_segment(slot, tail, room)
                remaining -= room
        if remaining == 0:
            return num_blocks

        # 2) open new extents while the budget allows (copy-free)
        while remaining > 0 and self.nsegs[slot] < self.max_segments:
            start = self._find_free_run(remaining, spread=True)
            if start >= 0:
                self._open_segment(slot, start, remaining)
                remaining = 0
                break
            # no single hole fits: take the largest hole (if last extent
            # slot, save it for the coalesce path instead of burning it)
            starts, lengths = self._free_runs()
            if len(starts) == 0:
                break
            if self.nsegs[slot] == self.max_segments - 1:
                break
            j = int(np.argmax(lengths))
            take = min(int(lengths[j]), remaining)
            self._open_segment(slot, int(starts[j]), take)
            remaining -= take
        if remaining == 0:
            return num_blocks
        if not sync:
            # eager mode never copies; report what we managed
            return num_blocks - remaining

        # 3) budget exhausted: coalesce extents (device copies)
        self._coalesce_and_grow(slot, remaining, plan)
        return num_blocks

    # ------------------------------------------------------------------ #
    # Coalescing / defragmentation (device-copy paths)
    # ------------------------------------------------------------------ #
    def _unclaim_slot(self, slot: int) -> None:
        for off, n in self._slot_segments(slot):
            self.block_owner[off:off + n] = -1

    def _coalesce_and_grow(self, slot: int, num_blocks: int,
                           plan: RelocationPlan) -> None:
        """Merge ``slot``'s extents into one run with room for
        ``num_blocks`` more; last resort, costs device copies."""
        cur = int(self.mapped_blocks[slot])
        needed = cur + num_blocks
        free = self._free_block_count()
        if free < num_blocks:
            self._reclaim_excluding(num_blocks, slot)
            free = self._free_block_count()
        # headroom throttled by pool pressure
        headroom = min(cur, max(0, free - num_blocks) // 2)
        want = min(needed + headroom, self.max_blocks_per_req)
        n0 = len(plan.moves)
        for target in (want, needed) if want > needed else (needed,):
            if free < target - cur:
                continue
            start = self._place_via_eviction(slot, target, plan)
            if start >= 0:
                if cur > 0:
                    self._move_slot_to(slot, start, plan)
                    self._extend_last_segment(
                        slot, start + cur, target - cur)
                else:
                    self._open_segment(slot, start, target)
                self.stats["coalesce"] += len(plan.moves) - n0
                self.stats["coalesce_events"] += 1
                return
        if self._free_block_count() >= num_blocks:
            self._repack_with_gaps(slot, needed, plan)
            self.stats["repack"] += len(plan.moves) - n0
            self.stats["repack_events"] += 1
            return
        self.verbose = True
        self.show_allocator_state()
        raise RuntimeError(
            "***** OOM on demand: not enough free pages to continue *****")

    def _move_slot_to(self, slot: int, start: int,
                      plan: RelocationPlan) -> None:
        """Copy ``slot``'s extents, in token order, into the (reserved)
        run at ``start``; collapses them to a single extent.

        The destination window was opened by ``_place_via_eviction`` and
        may only contain our own blocks; moves are emitted via the
        permutation router to stay order-safe.
        """
        segs = self._slot_segments(slot)
        cur = sum(n for _, n in segs)
        if not segs:
            return
        # build per-block move map (src -> dst in token order)
        moves = {}
        dst = start
        for off, n in segs:
            for i in range(n):
                if off + i != dst:
                    moves[off + i] = dst
                dst += 1
        if moves:
            self._route_moves(moves, plan)
        # bookkeeping: one extent
        self._unclaim_slot(slot)
        self.seg_off[slot, :] = -1
        self.seg_len[slot, :] = 0
        self.seg_off[slot, 0] = start
        self.seg_len[slot, 0] = cur
        self.nsegs[slot] = 1
        self.block_owner[start:start + cur] = slot

    def _route_moves(self, moves: Dict[int, int],
                     plan: RelocationPlan) -> None:
        """Emit ``moves`` (src block -> dst block) in an execution order
        that is safe for sequential device copies.

        Classic permutation routing: execute a move only when its
        destination is free; break cycles by bouncing one block through a
        scratch free block.  This is the TPU analog of remapping page
        tables: the defragmenter behind the <1% fragmentation target.
        """
        occupied = set()
        for s in range(self.max_batch_size):
            for off, n in self._slot_segments(s):
                occupied.update(range(off, off + n))
        pending = dict(moves)
        wanted = set(moves.values())
        src_of_dst = {d: s for s, d in pending.items()}
        assert len(src_of_dst) == len(pending), "duplicate destinations"
        ready = [s for s, d in pending.items() if d not in occupied]
        while pending:
            if not ready:
                src = next(iter(pending))
                candidates = [b for b in range(self.num_arena_blocks)
                              if b not in occupied]
                assert candidates, "no scratch block for cycle breaking"
                non_wanted = [b for b in candidates if b not in wanted]
                scratch = non_wanted[0] if non_wanted else candidates[0]
                plan.moves.append(Relocation(src, scratch))
                d = pending.pop(src)
                del src_of_dst[d]
                occupied.discard(src)
                occupied.add(scratch)
                pending[scratch] = d
                src_of_dst[d] = scratch
                ready = [s for s, dd in pending.items() if dd not in occupied]
                continue
            src = ready.pop()
            dst = pending.pop(src)
            del src_of_dst[dst]
            plan.moves.append(Relocation(src, dst))
            occupied.discard(src)
            occupied.add(dst)
            if src in src_of_dst and src_of_dst[src] in pending:
                ready.append(src_of_dst[src])

    def _window_layout(self, slot: int, i: int, n: int):
        """Plan clearing [i, i+n) of everything except ``slot``'s blocks:
        evict intersecting extents (of other slots) into free space.

        Returns ``(cost_blocks, seg_moves)`` or None if infeasible, where
        ``seg_moves`` is {(other_slot, seg_idx): new_offset}.
        """
        N = self.num_arena_blocks
        if i < 0 or i + n > N:
            return None
        owner = self.block_owner
        evicted: List[Tuple[int, int]] = []  # (slot, seg)
        for s in set(int(o) for o in owner[i:i + n]) - {-1, slot}:
            for si, (off, m) in enumerate(self._slot_segments(s)):
                if off < i + n and off + m > i:
                    evicted.append((s, si))
        evicted.sort(key=lambda e: -int(self.seg_len[e[0], e[1]]))
        cost = sum(int(self.seg_len[s, si]) for s, si in evicted)
        # free space outside the window, with evicted extents removed
        tmp = owner.copy()
        for s, si in evicted:
            off, m = int(self.seg_off[s, si]), int(self.seg_len[s, si])
            tmp[off:off + m] = -1
        tmp[i:i + n] = np.iinfo(np.int32).max  # reserved
        seg_moves = {}
        for s, si in evicted:
            m = int(self.seg_len[s, si])
            free = tmp == -1
            padded = np.concatenate(([False], free, [False]))
            diff = np.diff(padded.astype(np.int8))
            starts = np.nonzero(diff == 1)[0]
            lens = np.nonzero(diff == -1)[0] - starts
            cand = lens >= m
            if not cand.any():
                return None
            j = int(np.argmin(np.where(cand, lens, np.iinfo(np.int64).max)))
            seg_moves[(s, si)] = int(starts[j])
            tmp[starts[j]:starts[j] + m] = s
        return cost, seg_moves

    def _apply_seg_moves(self, seg_moves: Dict[Tuple[int, int], int],
                         plan: RelocationPlan) -> None:
        moves = {}
        for (s, si), new_off in seg_moves.items():
            off, m = int(self.seg_off[s, si]), int(self.seg_len[s, si])
            for k in range(m):
                if off + k != new_off + k:
                    moves[off + k] = new_off + k
        if moves:
            self._route_moves(moves, plan)
        for (s, si), new_off in seg_moves.items():
            off, m = int(self.seg_off[s, si]), int(self.seg_len[s, si])
            self.block_owner[off:off + m] = -1
        for (s, si), new_off in seg_moves.items():
            m = int(self.seg_len[s, si])
            self.seg_off[s, si] = new_off
            self.block_owner[new_off:new_off + m] = s

    def _place_via_eviction(self, slot: int, n: int,
                            plan: RelocationPlan) -> int:
        """Open an n-block window for ``slot`` at minimum copy cost.

        Candidates: a window anchored at the first extent's offset (so the
        head does not move) plus the globally cheapest windows by
        live-block count.  Returns window start or -1.
        """
        N = self.num_arena_blocks
        if n > N:
            return -1
        owner = self.block_owner
        live_other = ((owner != -1) & (owner != slot)).astype(np.int64)
        win_cost = np.convolve(live_other, np.ones(n, dtype=np.int64),
                               mode="valid")
        candidates = []
        if self.nsegs[slot] > 0:
            candidates.append(int(self.seg_off[slot, 0]))
        candidates.extend(
            int(i) for i in np.argsort(win_cost, kind="stable")[:8])
        best = None
        seen = set()
        for i in candidates:
            if i in seen:
                continue
            seen.add(i)
            r = self._window_layout(slot, i, n)
            if r is None:
                continue
            if best is None or r[0] < best[1][0]:
                best = (i, r)
            if r[0] == 0:
                break
        if best is None:
            return -1
        i, (cost, seg_moves) = best
        if seg_moves:
            self._apply_seg_moves(seg_moves, plan)
        return i

    def _repack_with_gaps(self, slot: int, needed: int,
                          plan: RelocationPlan) -> int:
        """Repack every request into ONE extent each, in slot order,
        spreading half the free space as per-run tail gaps (the other half
        stays as a contiguous reserve for incoming prefills).  Returns
        ``slot``'s new offset (with room for ``needed`` blocks).

        Global defragment-and-coalesce; amortized by the gaps
        (generational-GC style).  Inactive warm runs are dropped first.
        """
        for s in range(self.max_batch_size):
            if not self.is_active_req(s) and self.mapped_blocks[s] > 0:
                self.release_kvcache_blocks_all(s)
        cur = int(self.mapped_blocks[slot])
        order = [int(s) for s in np.argsort(self.run_offset)
                 if self.run_offset[s] >= 0 and int(s) != slot]
        targets = {s: int(self.mapped_blocks[s]) for s in order}
        targets[slot] = max(needed, cur)
        total = sum(targets.values())
        leftover = self.num_arena_blocks - total
        assert leftover >= 0, "caller must ensure capacity"
        n_runs = len(targets)
        gap = (leftover // 2) // (n_runs + 1) if n_runs else 0
        # route all data into the new layout in one pass
        moves = {}
        cursor = 0
        final = {}
        for s in order + [slot]:
            final[s] = cursor
            dst = cursor
            for off, m in self._slot_segments(s):
                for k in range(m):
                    if off + k != dst:
                        moves[off + k] = dst
                    dst += 1
            cursor += targets[s] + gap
        if moves:
            self._route_moves(moves, plan)
        # bookkeeping: single extent per slot
        self.block_owner[:] = -1
        for s, off in final.items():
            m = int(self.mapped_blocks[s])
            self.seg_off[s, :] = -1
            self.seg_len[s, :] = 0
            if s == slot:
                m = targets[slot]
            if m > 0:
                self.seg_off[s, 0] = off
                self.seg_len[s, 0] = m
                self.nsegs[s] = 1
                self.block_owner[off:off + m] = s
            else:
                self.nsegs[s] = 0
        logger.debug("repacked arena (gap=%d blocks) for slot %d", gap, slot)
        return final.get(slot, -1)

    # ------------------------------------------------------------------ #
    # Reclamation (ref vattention.cu:420-469)
    # ------------------------------------------------------------------ #
    def reclaim_kvblocks_on_demand(self, num_kvblocks: int) -> None:
        """Trim over-committed tails, highest slot first (ref :420-438)."""
        for slot in range(self.max_batch_size - 1, -1, -1):
            if self.kvblocks_available(num_kvblocks):
                break
            required = self.tokens_to_blocks(self.seq_lens[slot])
            if self.mapped_blocks[slot] <= required:
                continue
            self.release_kvcache_blocks_some(slot, required)

    def _reclaim_excluding(self, num_kvblocks: int, slot: int) -> None:
        """Trim other slots' over-committed tails, leaving one lookahead
        block when possible so trimmed slots do not churn next step."""
        for retain_extra in (1, 0):
            for s in range(self.max_batch_size - 1, -1, -1):
                if s == slot or self.kvblocks_available(num_kvblocks):
                    return
                required = self.tokens_to_blocks(self.seq_lens[s])
                if self.mapped_blocks[s] > required + retain_extra:
                    self.release_kvcache_blocks_some(
                        s, required + retain_extra)

    def do_reclaim_pages(self) -> None:
        """Lazily release one over-committed block per step (ref :444-469).

        Skips the slot most likely to be handed to the next prefill so its
        warm blocks can be reused.
        """
        if self.deferred_reclaim:
            return
        next_prefill = -1
        for slot in range(self.max_batch_size):
            if not self.is_active_req(slot):
                next_prefill = slot
                break
        for slot in range(self.max_batch_size - 1, -1, -1):
            if self.is_active_req(slot) or slot == next_prefill:
                continue
            if self.mapped_blocks[slot] == 0:
                continue
            self._release_tail_block(slot)
            break

    # ------------------------------------------------------------------ #
    # Per-step entry points (ref step_sync :395-409, step_async :549-558)
    # ------------------------------------------------------------------ #
    def _map_blocks_for_curr_step(self, slot: int, seq_len: int,
                                  plan: RelocationPlan) -> None:
        """ref map_pages_for_curr_step, vattention.cu:378-393."""
        required = self.tokens_to_blocks(seq_len)
        mapped = int(self.mapped_blocks[slot])
        if required > mapped:
            self._grow(slot, required - mapped, True, plan)
        self.seq_lens[slot] = seq_len

    def step_sync(self, seq_lens: Sequence[int],
                  eager_reclaim: bool = False) -> RelocationPlan:
        plan = RelocationPlan()
        for slot in range(self.max_batch_size):
            sl = int(seq_lens[slot])
            self.seq_lens[slot] = sl
            if eager_reclaim and sl == 0 and self.mapped_blocks[slot] != 0:
                self.release_kvcache_blocks_all(slot)
                continue
            self._map_blocks_for_curr_step(slot, sl, plan)
        return plan

    def _need_new_blocks_async(self, slot: int, eager_steps: int) -> int:
        """ref need_new_page_async, utils.h:206-219."""
        if not self.is_active_req(slot):
            return 0
        mapped = int(self.mapped_blocks[slot])
        if mapped >= self.max_blocks_per_req:
            return 0
        required = self.tokens_to_blocks(int(self.seq_lens[slot]) + eager_steps)
        return max(0, required - mapped)

    def do_kvcache_memory_management(self, plan: RelocationPlan) -> None:
        """Eager decode growth + lazy reclaim (ref :488-536).

        On GPU this runs in a detached thread because cuMemMap blocks;
        here commitment is bookkeeping and relocation copies are async
        device work, so it runs inline while preserving the lookahead
        semantics.  Eager growth is copy-free (in-place extension only).
        """
        nr_required = sum(
            self._need_new_blocks_async(s, 1)
            for s in range(self.max_batch_size))
        if not self.kvblocks_available(nr_required):
            self.reclaim_kvblocks_on_demand(nr_required)
        if not self.kvblocks_available(nr_required):
            return
        nr_mapped = 0
        done = False
        # under pool pressure, lookahead beyond the next token only creates
        # overcommit that reclamation undoes next step
        num_active = int(np.count_nonzero(self.seq_lens))
        eager_limit = (EAGER_NUM_STEPS
                       if self._free_block_count() >= 2 * num_active else 2)
        for eager_step in range(1, eager_limit):
            if done:
                break
            for slot in range(self.max_batch_size):
                need = self._need_new_blocks_async(slot, eager_step)
                nr_mapped += self._grow(slot, need, False, plan)
                if eager_step == 1:
                    continue
                if nr_mapped >= EAGER_NUM_KVBLOCKS:
                    done = True
                    break
        if nr_required:
            return
        self.do_reclaim_pages()

    def step_async(self, seq_lens: Sequence[int]) -> RelocationPlan:
        """One call per iteration (ref step_async, vattention.cu:549-558).

        Synchronously guarantees blocks for this step's (prefill) tokens,
        then plans eager decode growth; the returned plan's device copies
        are dispatched asynchronously by the cache engine and overlap with
        the forward pass.
        """
        plan = RelocationPlan()
        for slot in range(self.max_batch_size):
            self.seq_lens[slot] = int(seq_lens[slot])
        for slot in range(self.max_batch_size):
            self._map_blocks_for_curr_step(
                slot, int(self.seq_lens[slot]), plan)
        self.do_kvcache_memory_management(plan)
        return plan

    # ------------------------------------------------------------------ #
    # Request slot management (ref :564-594)
    # ------------------------------------------------------------------ #
    def alloc_new_batch_idx(self, seqlen: int) -> int:
        """Best-fit inactive slot reuse (ref alloc_new_batch_idx :564-589).

        Prefers the inactive slot whose existing extents already have
        enough blocks (smallest adequate), avoiding placement work.
        """
        nr_required = self.tokens_to_blocks(seqlen)
        mapped = self.mapped_blocks
        new_id = -1
        for slot in range(self.max_batch_size):
            if self.is_active_req(slot):
                continue
            if new_id == -1:
                new_id = slot
                continue
            if (mapped[slot] >= nr_required
                    and mapped[slot] < mapped[new_id]):
                new_id = slot
        if new_id != -1:
            self.seq_lens[new_id] = seqlen
        return new_id

    def free_batch_idx(self, req_id: int) -> None:
        self.seq_lens[req_id] = 0

    def set_deferred_reclamation(self, val: bool) -> None:
        self.deferred_reclaim = val

    def set_verbose(self, val: bool) -> None:
        self.verbose = val

    def cleanup(self) -> None:
        if not self.is_configured:
            return
        for slot in range(self.max_batch_size):
            self.seq_lens[slot] = 0
            self.release_kvcache_blocks_all(slot)
        self.is_configured = False

    # ------------------------------------------------------------------ #
    # Introspection (ref show_allocator_state, vattention.cu:77-95)
    # ------------------------------------------------------------------ #
    def show_allocator_state(self) -> None:
        logger.info("Free pool: %d KV blocks", self._free_block_count())
        logger.info("   slot :   seqlen :  mapped : required : segments")
        for i in range(self.max_batch_size):
            logger.info(
                "%7d : %8d : %7d : %8d : %s", i, self.seq_lens[i],
                self.mapped_blocks[i],
                self.tokens_to_blocks(self.seq_lens[i]),
                self._slot_segments(i))

    def fragmentation_overhead(self) -> float:
        """Fraction of arena blocks lost to over-commitment/headroom."""
        required = sum(
            self.tokens_to_blocks(s) for s in self.seq_lens if s > 0)
        mapped = self.mapped_blocks
        used = int(sum(mapped[s] for s in range(self.max_batch_size)
                       if self.seq_lens[s] > 0))
        if self.num_arena_blocks == 0:
            return 0.0
        return (used - required) / self.num_arena_blocks
