"""Sweep kernel C's split plan against its bytes bound on the H100.

Twin of ``microbenchmarks/bench_decode_kernel.py:27-122``: the same shapes and
flags (``--batch`` slots at depth ``--ctx``, ``--hq`` query heads on
``--hkv`` kv heads of ``--head-dim``, ``--layers`` calls per timed program
over ``--layers-alloc`` arena layers, ``--block-tokens``-row tables,
``--kv-dtype`` bf16, fp8 or int8).  The JAX sweep's knobs (``kv_tile``,
``kv_fetch``, ``seq_tile``) are TPU tiling with no counterpart here; this
twin sweeps C's split plan instead (``ops/flash_decode.py``):
``MIN_SPLIT_TILES``, a split's least 64-position tiles, and
``BLOCKS_PER_SM``, the fixed grid's blocks per SM, given as ``--plans
M:B ...`` (today's defaults, 4:2, first).

Each point's output is first held against C's plain version on the same
inputs (``timing.check_attention``: atol = rtol = 2e-2, each slot within
2^-6 of its largest output; a failure raises), then ``--layers`` chained
calls (each call's output the next one's query, as in the JAX program)
are timed with ``timing.Timer`` (each timed program after an L2 flush).
Per point it prints the grid, ms per ``--layers`` calls, the K/V rate and
its share of the bytes bound at 3.35 TB/s (K and V of every live position
read once per call).  The arena holds random values from one seeded
generator; each slot's rows are contiguous.

With ``--device cpu`` the plain version runs at tiny shapes (batch at
most 2, ctx at most 512, at most 2 layers and 2 timed programs) and times
are host wall clock; without a GPU it raises unless given ``--device cpu``.

    python -m vattention_tpu_torch.microbenchmarks.bench_decode_kernel \\
        --batch 2 --ctx 131072 --plans 4:2 1:2 16:2 4:4
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import (
    PEAK_BYTES_PER_S, Timer, bound, cap_for_cpu, check_attention, seeded)

KV_DTYPES = {"bf16": None, "fp8": torch.float8_e4m3fn, "int8": torch.int8}
INT8_STEP = 0.04
CPU_MAX = dict(batch=2, ctx=512, layers=2, iters=2)
DEFAULT_PLANS = ["4:2", "1:2", "2:2", "8:2", "16:2", "4:1", "4:3", "4:4"]


def parse_plan(text: str) -> tuple:
    m, b = (int(x) for x in text.split(":"))
    if m < 1 or b < 1:
        raise argparse.ArgumentTypeError(f"plan {text}: both parts >= 1")
    return m, b


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--ctx", type=int, default=1024)
    p.add_argument("--hq", type=int, default=32)
    p.add_argument("--hkv", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--block-tokens", type=int, default=256)
    p.add_argument("--kv-dtype", choices=sorted(KV_DTYPES), default="bf16")
    p.add_argument("--layers-alloc", type=int, default=2)
    p.add_argument("--plans", nargs="+", type=parse_plan,
                   default=[parse_plan(x) for x in DEFAULT_PLANS],
                   help="MIN_SPLIT_TILES:BLOCKS_PER_SM points")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain version, tiny "
                        "shapes)")
    return p


def sweep(args) -> List[dict]:
    """Print the table; returns a row per plan point."""
    from vattention_tpu_torch.ops.flash_decode import (
        decode_attention, decode_attention_plain, decode_grid)
    from vattention_tpu_torch.ops.utils import quantize_kv
    from vattention_tpu_torch.scripts.common import resolve

    dev = resolve(args.device)
    if dev.type == "cpu":
        print("--device cpu: C's plain version on the CPU; times are host "
              "wall clock, not device times", file=sys.stderr)
        cap_for_cpu(args, CPU_MAX)
    B, Hq, Hkv, D = args.batch, args.hq, args.hkv, args.head_dim
    L, Lc = args.layers, args.layers_alloc
    ctx, BT = args.ctx, args.block_tokens
    ctx_pad = -(-ctx // BT) * BT
    randn, i32 = seeded(dev)
    kv = randn(Lc, 2, Hkv, ctx_pad * B, D)
    sm = D ** -0.5
    out_scale = 1.0
    arena = KV_DTYPES[args.kv_dtype]
    if arena is not None:
        kv = quantize_kv(kv, arena, INT8_STEP)
        if arena == torch.int8:
            sm *= INT8_STEP
            out_scale = INT8_STEP
    q = randn(B, Hq, D)
    rows = i32(np.arange(B)[:, None] * ctx_pad
               + np.arange(ctx_pad // BT)[None, :] * BT)
    seqlens = i32(np.full(B, ctx))
    kv_bytes = B * ctx * Hkv * D * 2 * kv.element_size()  # K + V
    bound_ms, _ = bound(L * kv_bytes, 0)
    print(f"KV traffic per call: {kv_bytes / 1e6:.1f} MB; bound per {L} "
          f"calls: {bound_ms:.4f} ms at {PEAK_BYTES_PER_S / 1e12} TB/s",
          flush=True)
    timer = Timer(dev)
    out = []
    print(f"{'min_split':>9} {'blk/SM':>6} {'grid':>5} {'ms/L-calls':>11} "
          f"{'GB/s':>8} {'%bound':>7} {'max abs err':>12}", flush=True)
    for m, bps in args.plans:
        plan = dict(min_split_tiles=m, blocks_per_sm=bps)

        def call(qq, layer):
            return decode_attention(qq, kv, rows, seqlens, layer, sub=BT,
                                    sm_scale=sm, **plan)

        err, _ = check_attention(
            f"bench_decode_kernel plan {m}:{bps}", call(q, 0),
            decode_attention_plain(q, kv, rows, seqlens, 0, sub=BT,
                                   sm_scale=sm), scale=out_scale)

        def many():
            o = q
            for i in range(L):
                o = call(o, i % Lc)
            return o

        ms = timer(many, iters=args.iters)
        gbps = L * kv_bytes / (ms * 1e-3) / 1e9
        grid = decode_grid(dev, bps) if dev.type == "cuda" else None
        out.append(dict(min_split_tiles=m, blocks_per_sm=bps, grid=grid,
                        ms=ms, gbps=gbps, bound_ms=bound_ms,
                        pct_bound=100 * bound_ms / ms, max_abs_err=err))
        print(f"{m:>9} {bps:>6} {grid if grid else '-':>5} {ms:>11.4f} "
              f"{gbps:>8.0f} {100 * bound_ms / ms:>6.1f}% {err:>12.3g}",
              flush=True)
    return out


def main(argv=None) -> int:
    sweep(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
