"""Page-size sensitivity of the attention kernels' latency, on the H100.

Twin of ``microbenchmarks/perf_pagesize/bench_pagesize.py``, the
vAttention claim that small pages do not slow the attention kernel down:
at pages of 64 KB, 256 KB and 2 MB, with block_tokens as the allocator
computes it (``VAttentionAllocator.init_kvcache``), it prints

    page_size\\tblock_tokens\\tprefill_ms\\tdecode_ms

- prefill: kernel G, a ``--chunk``-token chunk ending at depth ``--ctx``
  over the JAX twin's single extent at arena row 0;
- decode: kernel C, ``--batch`` sequences at depth ``--ctx``, one extent
  each at the JAX twin's rows, at ``sub = select_kv_tile(block_tokens,
  256)``, as the arena backend picks it.

G resolves each key's row from the extent table and the single extent does
not depend on the page, so the prefill column is the same call three times:
its spread is the timing's noise, the claim holding by construction.  The
decode column is C at ``sub = 64`` (64 KB pages at Yi-6B's geometry)
against C at ``sub = 256`` (256 KB and 2 MB, the same call twice).  Times are the
mean of ``--iters`` calls, each after an L2 flush (``timing.Timer``); data
is random, from one seeded ``torch.Generator``.

    python -m vattention_tpu_torch.microbenchmarks.bench_pagesize \\
        [--ctx 8192] [--chunk 2048] [--batch 16]

With ``--cpu`` the plain versions run on the CPU at tiny shapes (ctx at
most 512, chunk at most 128, batch at most 2, at most 2 timed calls) and
the times are host wall clock.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vattention_tpu_torch.microbenchmarks.timing import (
    Timer, cap_for_cpu, harness_device, seeded)

HEADER = "page_size\tblock_tokens\tprefill_ms\tdecode_ms"
KB, MB = 1024, 1024 * 1024
PAGES = (64 * KB, 256 * KB, 2 * MB)
ARENA_ROWS = 36864
CPU_MAX = dict(ctx=512, chunk=128, batch=2, iters=2)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ctx", type=int, default=8192)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--kv-heads", type=int, default=4)
    p.add_argument("--q-heads", type=int, default=32)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--cpu", action="store_true",
                   help="plain versions on the CPU at tiny shapes")
    return p


def page_label(page: int) -> str:
    return f"{page // KB}KB" if page < MB else f"{page // MB}MB"


def block_tokens(page: int, args) -> int:
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator

    alloc = VAttentionAllocator()
    alloc.init_kvcache(num_layers=1, num_kv_heads=args.kv_heads,
                       head_size=args.head_dim, max_batch_size=args.batch,
                       max_context_length=args.ctx, dtype_bytes=2,
                       page_size=page)
    return alloc.block_tokens


def bench(args) -> list:
    """Print the table; returns its rows (label, block_tokens, prefill ms,
    decode ms)."""
    from vattention_tpu_torch.model_executor.attention.vattn_backend import (
        TABLE_SUB)
    from vattention_tpu_torch.ops.flash_decode import decode_attention
    from vattention_tpu_torch.ops.flash_prefill import (
        MAX_SEGMENTS, segment_prefill_attention)
    from vattention_tpu_torch.ops.utils import (cdiv, select_kv_tile,
                                                tile_rows_from_segments)

    dev = harness_device(args.cpu)
    if args.cpu:
        cap_for_cpu(args, CPU_MAX)
    Hkv, Hq, D = args.kv_heads, args.q_heads, args.head_dim
    B, S, R = args.batch, MAX_SEGMENTS, ARENA_ROWS
    sm = D ** -0.5
    randn, i32 = seeded(dev)

    kv = randn(1, 2, Hkv, R, D)
    q = randn(args.chunk, Hq, D)
    qd = randn(B, Hq, D)
    seqlens = i32(np.full(B, args.ctx))
    # prefill: the chunk attends the full ctx through one extent at row 0
    seg_row = i32(np.zeros(S))
    seg_cum = i32([0] + [args.ctx] * S)
    qinfo = i32([args.ctx - args.chunk, args.ctx])
    timer = Timer(dev)
    rows = []
    print(HEADER, flush=True)
    for page in PAGES:
        bt = block_tokens(page, args)
        tp = timer(lambda: segment_prefill_attention(
            q, kv, seg_row, seg_cum, qinfo, 0, sm_scale=sm),
            iters=args.iters)
        # decode: a batch of ctx-long sequences, one extent each
        rows_per_seq = cdiv(args.ctx, bt) * bt + bt
        sr = np.zeros((B, S), np.int32)
        sr[:, 0] = (np.arange(B) * rows_per_seq) % (R - rows_per_seq)
        sc = np.zeros((B, S + 1), np.int32)
        sc[:, 1:] = cdiv(args.ctx, bt) * bt
        sub = select_kv_tile(bt, TABLE_SUB)
        tile_rows = i32(tile_rows_from_segments(sr, sc, sub,
                                                cdiv(args.ctx, sub)))
        td = timer(lambda: decode_attention(qd, kv, tile_rows, seqlens, 0,
                                            sub=sub, sm_scale=sm),
                   iters=args.iters)
        label = page_label(page)
        rows.append((label, bt, tp, td))
        print(f"{label}\t{bt}\t{tp:.3f}\t{td:.3f}", flush=True)
    return rows


def main(argv=None) -> int:
    bench(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
