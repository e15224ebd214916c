"""Standalone KV-arena allocator demo (ref:
microbenchmarks/vattn_samples/vattn_demo_async.py and vattn_demo_sync.py).

Twin of ``examples/allocator_demo.py:19-88`` over the port's allocator
(``vattention_tpu_torch/memory``), the native C++ core by default as in the
engine (``--allocator python`` takes ``memory/allocator.py``): the same
flags, seed and simulated serving workload (requests arrive with random
prompt lengths, decode for a while and finish; when the pool cannot hold
one more block per active request the newest is preempted).  Every 500
steps it prints the average and p99 milliseconds the allocator's step
blocks for (the reference's KV-allocation latency), the relocation copies
and their MB per step, the active requests, the free KV blocks and the
fragmentation.  ``--sync`` steps with ``step_sync`` (every block mapped at
the step boundary, as ``vattn_demo_sync``), the default with
``step_async`` (eager lookahead and deferred reclamation, as
``vattn_demo_async``).  The allocator keeps host bookkeeping only;
``--device`` is checked as in the other scripts and raises without a GPU
unless given ``cpu``.

    python -m vattention_tpu_torch.examples.allocator_demo \\
        [--page-size-kb 64] [--steps 2000] [--sync] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np

KB, MB = 1024, 1024 * 1024


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--page-size-kb", type=int, default=64)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--memory-mb", type=int, default=256)
    p.add_argument("--max-context", type=int, default=8192)
    p.add_argument("--megacache", action="store_true")
    p.add_argument("--sync", action="store_true",
                   help="step_sync instead of step_async "
                        "(ref vattn_demo_sync.py vs vattn_demo_async.py)")
    p.add_argument("--allocator", choices=("native", "python"),
                   default="native")
    p.add_argument("--device", default="cuda", help="cuda (the default) or "
                                                    "cpu")
    return p


def make_allocator(kind: str):
    if kind == "python":
        from vattention_tpu_torch.memory import VAttentionAllocator

        return VAttentionAllocator()
    from vattention_tpu_torch.memory.native import NativeVAttentionAllocator

    return NativeVAttentionAllocator()


def run(args) -> List[dict]:
    """The demo; returns one dict per printed pass."""
    from vattention_tpu_torch.scripts.common import resolve

    resolve(args.device)
    alloc = make_allocator(args.allocator)
    alloc.init_kvcache(
        num_layers=8, num_kv_heads=4, head_size=128,
        max_batch_size=args.max_batch_size,
        max_context_length=args.max_context,
        dtype_bytes=2, page_size=args.page_size_kb * KB,
        megacache=args.megacache)
    pages = alloc.reserve_physical_pages(args.memory_mb * MB)
    print(f"arena ({args.allocator} allocator): {alloc.num_arena_blocks} KV "
          f"blocks ({pages} pages of {args.page_size_kb}KB, "
          f"{alloc.block_tokens} tokens/block, "
          f"{alloc.arena_tokens} arena token rows)")

    rng = np.random.default_rng(0)
    active = {}
    passes = []
    step_times, relocs, admitted, finished = [], 0, 0, 0
    step = alloc.step_sync if args.sync else alloc.step_async
    for it in range(args.steps):
        if len(active) < args.max_batch_size - 2 and rng.random() < 0.4:
            prompt = int(rng.integers(64, 2048))
            if alloc.tokens_to_blocks(prompt) < alloc.num_free_kvblocks():
                sid = alloc.alloc_new_batch_idx(prompt)
                if sid >= 0:
                    active[sid] = int(rng.integers(16, 256))
                    admitted += 1
        # scheduler-style backpressure: if the pool cannot hold one more
        # block per active request, preempt the newest request
        # (ref base_scheduler.py:135-143 can_append_slot/preempt loop)
        while alloc.num_free_kvblocks() < len(active) and len(active) > 1:
            victim = list(active)[-1]
            alloc.free_batch_idx(victim)
            del active[victim]
        # the native core hands out a copy of its lengths
        seq_lens = np.array(alloc.seq_lens, np.int64)
        for sid in list(active):
            seq_lens[sid] += 1
            active[sid] -= 1
        t0 = time.perf_counter()
        plan = step(seq_lens)
        step_times.append(time.perf_counter() - t0)
        relocs += len(plan)
        for sid in [s for s, d in active.items() if d <= 0]:
            alloc.free_batch_idx(sid)
            del active[sid]
            finished += 1
        if (it + 1) % 500 == 0:
            mb_per_step = (relocs / (it + 1)) * alloc.kvblock_bytes / MB
            row = dict(step=it + 1, avg_ms=np.mean(step_times) * 1e3,
                       p99_ms=np.percentile(step_times, 99) * 1e3,
                       relocs=relocs, mb_per_step=mb_per_step,
                       active=len(active),
                       free_kvblocks=alloc.num_free_kvblocks(),
                       fragmentation=alloc.fragmentation_overhead())
            passes.append(row)
            print(f"pass {it+1}: avg step {row['avg_ms']:.3f} ms, "
                  f"p99 {row['p99_ms']:.3f} ms, "
                  f"reloc copies: {relocs} ({mb_per_step:.2f} MB/step), "
                  f"active: {len(active)}, "
                  f"free kvblocks: {row['free_kvblocks']}, "
                  f"fragmentation: {row['fragmentation']*100:.2f}%")
            step_times = []

    print(f"done: admitted {admitted}, finished {finished}, "
          f"total relocation copies {relocs}")
    alloc.cleanup()
    print("cleaned up.")
    return passes


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    main()
