"""Time kernel D (``ops/arena_copy.arena_relocate``) call by call at the
arenas and plans the port relocates.

    python -m vattention_tpu_torch.microbenchmarks.bench_relocate \\
        --geometry yi falcon tp2 rdyn --calls 20 [--plans]

Geometries (``GEOMETRIES``; bfloat16 arenas ``[L, 2, Hkv, R, 128]``):
``yi`` is yi-6b-200k on fa_vattn_2mb (32 layers, 4 kv heads, 2048-token
blocks; chip_smoke (a)); ``falcon`` one kv head at 8192-token blocks
(falcon-7b's arena, and Yi's on one rank of tp 4; (a falcon), (a tp4));
``tp2`` Yi on one rank of tp 2 (2 kv heads, 4096-token blocks; (a
tp2)); ``rdyn`` yi-6b-200k-l16 on fa_vattn_64kb (16 layers, 4 kv heads,
64-token blocks, a 2 GiB arena of 65,536 tokens; chip_smoke (r dyn), the
serving cell that relocates).  Plans come from the allocator: at the
first three a plan with chained moves in strict contiguity
(``strict_relocation_plan``, chip_smoke (a)'s); at ``rdyn`` the first plan
of at least 200 moves under a seeded workload at 8 extents a request
(``dynamic_relocation_plan``).

For each geometry D is first held against ``arena_relocate_plain`` byte
for byte, then ``--calls`` single calls are timed with ``timing.Timer``
(each after an L2 flush), in turns with two yardsticks: a ``copy_`` of a
contiguous buffer that moves D's bytes (half read, half written: what
the card's copy engine path costs for the same bytes under this timer,
the practical ceiling) and the plan as one ``copy_`` per move of the
arena's block slices (the library call).  One line per geometry: the
plan's moves and batches, min / median / max ms of D and of the two
yardsticks, and D's bytes bound at 3.35 TB/s (each move's rows read and
written once in every slice).  It uses only ``arena_relocate`` and
``arena_relocate_plain``, so it times an earlier checkout's D too when
that checkout is first on ``PYTHONPATH``.

With ``--plans`` (on the card) D is also timed under every launch plan
its source takes (1, 2 or 4 offsets a thread, blocks of 128 or 256
threads, batches of 1 up to 16 / offsets moves), one line
``plan,geometry,vpt x threads x chunks x batch,ms min / median /
max,chosen`` each, ``chosen`` 1 for the wrapper's (``relocate_plan``).

With ``--device cpu`` the plain version runs on a tiny arena (the same
plans and blocks over 2 layers, 1 kv head and 16 lanes, rows cut to the
plan's last block) and times are host wall clock; without a GPU it
raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import (Timer, bound,
                                                         harness_device)
from vattention_tpu_torch.ops import arena_copy

PAGE_2MB, PAGE_64KB = 2 * 2**20, 64 * 2**10
# name: layers, kv heads, head dim, page bytes, extents a request, arena
# blocks (the dynamic plan's; the strict plans use STRICT_BLOCKS + 1)
GEOMETRIES = {
    "yi": dict(L=32, HKV=4, D=128, page=PAGE_2MB),
    "falcon": dict(L=32, HKV=1, D=128, page=PAGE_2MB),
    "tp2": dict(L=32, HKV=2, D=128, page=PAGE_2MB),
    "rdyn": dict(L=16, HKV=4, D=128, page=PAGE_64KB, segments=8,
                 blocks=1024),
}
STRICT_BLOCKS = 24
MIN_DYNAMIC_MOVES = 200
# the CPU's tiny arena: layers, kv heads, lanes
CPU_ARENA = dict(L=2, HKV=1, D=16)
CPU_MAX = dict(calls=2)


def strict_relocation_plan(L, HKV, D, es, seed=0, blocks=14):
    """A relocation plan with chained moves from the allocator in strict
    contiguity (max_segments=1) on a seeded dynamic workload, plus the
    arena rows of every live slot's tokens before and after the plan.
    Lengths scale with the block (2048 tokens at Yi's kv heads, 8192 at
    falcon's one), so requests cross blocks as often at any geometry."""
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator

    scale = max(1, PAGE_2MB // (HKV * D * es) // 2048)
    a = VAttentionAllocator()
    a.init_kvcache(num_layers=L, num_kv_heads=HKV, head_size=D,
                   max_batch_size=8, max_context_length=8192 * scale,
                   dtype_bytes=es, page_size=PAGE_2MB, max_segments=1)
    a.reserve_physical_pages(blocks * a.kvblock_bytes)
    rng = np.random.default_rng(seed)
    active = {}

    def rows_of(seg, slot, n):
        seg_row, seg_tok = seg
        rows = []
        for j in range(a.max_segments):
            rows.extend(range(seg_row[slot, j], seg_row[slot, j]
                              + seg_tok[slot, j]))
        return np.asarray(rows[:n], np.int64)

    for _ in range(5000):
        if len(active) < 7 and rng.random() < 0.5:
            prompt = int(rng.integers(10, 6000)) * scale
            if a.tokens_to_blocks(prompt) < a.num_free_kvblocks():
                sid = a.alloc_new_batch_idx(prompt)
                if sid >= 0:
                    active[sid] = int(rng.integers(4, 3000))
        while a.num_free_kvblocks() < len(active) and len(active) > 1:
            victim = list(active)[-1]
            a.free_batch_idx(victim)
            del active[victim]
        old_lens = a.seq_lens.copy()
        for sid in list(active):
            a.seq_lens[sid] += scale
            active[sid] -= 1
        before = a.get_batch_segments()
        plan = a.step_async(a.seq_lens.copy())
        srcs = [m.src for m in plan.moves]
        dsts = [m.dst for m in plan.moves]
        chained = any(dsts[i] in srcs[:i] or srcs[i] in dsts[:i]
                      for i in range(len(srcs)))
        if chained:
            after = a.get_batch_segments()
            live = [(rows_of(before, s, int(old_lens[s])),
                     rows_of(after, s, int(old_lens[s])))
                    for s in active if old_lens[s] > 0]
            return plan, live
        for sid in [s for s, d in active.items() if d <= 0]:
            a.free_batch_idx(sid)
            del active[sid]
    raise AssertionError("no chained relocation plan found")


def dynamic_relocation_plan(L, HKV, D, es, page, segments, blocks,
                            min_moves=MIN_DYNAMIC_MOVES, seed=0):
    """(the allocator's block tokens, the first plan of at least
    ``min_moves`` moves) under a seeded workload of up to 15 requests of
    10-20,000 prompt tokens, each growing by a token a step, in an arena
    of ``blocks`` blocks at ``segments`` extents a request."""
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator

    a = VAttentionAllocator()
    a.init_kvcache(num_layers=L, num_kv_heads=HKV, head_size=D,
                   max_batch_size=16, max_context_length=32768,
                   dtype_bytes=es, page_size=page, max_segments=segments)
    a.reserve_physical_pages(blocks * a.kvblock_bytes)
    rng = np.random.default_rng(seed)
    active = {}
    for _ in range(5000):
        if len(active) < 15 and rng.random() < 0.5:
            prompt = int(rng.integers(10, 20000))
            if a.tokens_to_blocks(prompt) < a.num_free_kvblocks():
                sid = a.alloc_new_batch_idx(prompt)
                if sid >= 0:
                    active[sid] = int(rng.integers(4, 3000))
        while a.num_free_kvblocks() < len(active) and len(active) > 1:
            victim = list(active)[-1]
            a.free_batch_idx(victim)
            del active[victim]
        for sid in list(active):
            a.seq_lens[sid] += 1
            active[sid] -= 1
        plan = a.step_async(a.seq_lens.copy())
        if len(plan.moves) >= min_moves:
            return a.block_tokens, plan
        for sid in [s for s, d in active.items() if d <= 0]:
            a.free_batch_idx(sid)
            del active[sid]
    raise AssertionError(f"no relocation plan of {min_moves} moves found")


def geometry(name: str, es: int = 2, tiny: bool = False):
    """(arena shape, block tokens, src list, dst list) of a geometry; with
    ``tiny`` the same plan over CPU_ARENA's slices, rows cut to its last
    block."""
    g = dict(GEOMETRIES[name])
    if "segments" in g:
        bt, plan = dynamic_relocation_plan(g["L"], g["HKV"], g["D"], es,
                                           g["page"], g["segments"],
                                           g["blocks"])
        rows = g["blocks"] * bt
    else:
        plan, _ = strict_relocation_plan(g["L"], g["HKV"], g["D"], es)
        bt = PAGE_2MB // (g["HKV"] * g["D"] * es)
        rows = (STRICT_BLOCKS + 1) * bt
    src = [m.src for m in plan.moves]
    dst = [m.dst for m in plan.moves]
    if tiny:
        g.update(CPU_ARENA)
        rows = (max(src + dst) + 1) * bt
    return (g["L"], 2, g["HKV"], rows, g["D"]), bt, src, dst


def relocation_bytes(shape, bt: int, n_moves: int, es: int = 2) -> int:
    """D's bytes: each move's block read and written once in every slice,
    and the plan's two int32 entries."""
    L, two, hkv, _, d = shape
    return n_moves * L * two * hkv * bt * d * es * 2 + n_moves * 8


def slice_copies(cache, src, dst, bt):
    """The plan as one ``copy_`` per move of the arena's block slices."""
    def run():
        for s, d in zip(src, dst):
            cache[:, :, :, d * bt:(d + 1) * bt].copy_(
                cache[:, :, :, s * bt:(s + 1) * bt])
    return run


def plans(num_slices: int, block_vecs: int):
    """Every launch plan D's source takes for these slices, as
    ``RelocPlan`` tuples: 1, 2 or 4 offsets a thread, 128 or 256
    threads, batches of 1 up to the most the source holds."""
    for vpt in (1, 2, arena_copy.MAX_RELOC_VECS):
        for threads in (128, 256):
            chunks = -(-block_vecs // (threads * vpt))
            batch = 1
            while batch <= arena_copy.BATCH_VECS // vpt:
                yield arena_copy.RelocPlan(vpt, threads, chunks, batch)
                batch *= 2


def with_plan(cache, src, dst, n_moves, bt, plan):
    """One launch of D under ``plan`` (no checks: ``plans`` makes only
    plans the source takes)."""
    from vattention_tpu_torch.ops.cuda_build import current_stream

    L, two, hkv, rows, d = cache.shape
    arena_copy.ARENA_RELOCATE(cache.data_ptr(), src.data_ptr(),
                              dst.data_ptr(), n_moves, L * two * hkv, rows,
                              d * cache.element_size(), bt, *plan,
                              current_stream())


def spread(times: List[float]) -> str:
    s = sorted(times)
    return f"{s[0]:.4f} / {s[len(s) // 2]:.4f} / {s[-1]:.4f}"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--geometry", nargs="+", choices=list(GEOMETRIES),
                   default=list(GEOMETRIES))
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--plans", action="store_true",
                   help="also time D under every launch plan its source "
                        "takes")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def run(args) -> None:
    dev = harness_device(args.device == "cpu")
    cpu = dev.type == "cpu"
    if cpu and args.plans:
        raise ValueError("--plans times the CUDA kernel: not with --device "
                         "cpu")
    if cpu:
        args.calls = min(args.calls, CPU_MAX["calls"])
    timer = Timer(dev)
    print("geometry,arena,block tokens,moves,batches,"
          "D ms min / median / max,copy of its bytes ms min / median / max,"
          "slice copies ms min / median / max,bound ms", flush=True)
    for name in args.geometry:
        shape, bt, src_l, dst_l = geometry(name, tiny=cpu)
        n = len(src_l)
        gen = torch.Generator(device=dev).manual_seed(18)
        cache = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
        src = torch.tensor(src_l, dtype=torch.int32, device=dev)
        dst = torch.tensor(dst_l, dtype=torch.int32, device=dev)
        expect = cache.clone()
        arena_copy.arena_relocate_plain(expect, src, dst, n, bt)
        arena_copy.arena_relocate(cache, src, dst, n, bt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(cache.view(torch.uint8), expect.view(torch.uint8)):
            raise AssertionError(f"{name}: D differs from "
                                 "arena_relocate_plain")
        del expect
        n_bytes = relocation_bytes(shape, bt, n)
        pair = torch.empty(2, n_bytes // 2, dtype=torch.uint8, device=dev)
        calls = {"kernel": lambda: arena_copy.arena_relocate(
                     cache, src, dst, n, bt),
                 "copy": lambda: pair[1].copy_(pair[0]),
                 "slices": slice_copies(cache, src_l, dst_l, bt)}
        ms = {k: [] for k in calls}
        for _ in range(args.calls):
            for k, call in calls.items():
                ms[k].append(timer(call, iters=1, warmup=0))
        del pair
        batches = len(arena_copy.relocation_batches(
            src_l, dst_l, n, arena_copy.BATCH_VECS)) if hasattr(
                arena_copy, "relocation_batches") else "-"
        print(f"{name},{list(shape)},{bt},{n},{batches},"
              f"{spread(ms['kernel'])},{spread(ms['copy'])},"
              f"{spread(ms['slices'])},{bound(n_bytes, 0)[0]:.5f}",
              flush=True)
        if args.plans:
            L, two, hkv, _, d = shape
            block_vecs = bt * d * cache.element_size() // 16
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chosen = arena_copy.relocate_plan(L * two * hkv, block_vecs, sms)
            for plan in plans(L * two * hkv, block_vecs):
                times = [timer(lambda: with_plan(cache, src, dst, n, bt,
                                                 plan), iters=1, warmup=0)
                         for _ in range(args.calls)]
                print(f"plan,{name},{' x '.join(map(str, plan))},"
                      f"{spread(times)},{int(plan == chosen)}", flush=True)
        del cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
