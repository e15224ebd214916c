"""POD attention against the serial kernels, on the H100.

Twin of ``microbenchmarks/bench_pod.py``, with its defaults: one prefill
chunk of ``--prefill`` tokens at a history of ``--history`` (one extent at
arena row 0) and ``--batch`` decode sequences at depth ``--ctx`` (one
extent each, packed after it), over ``--layers`` chained layer calls on a
2-layer cache.  Per layer call, ``serial`` runs kernel G then kernel C and
``pod_fused`` runs kernel F on the one prefill run and the batch; it
prints the JAX twin's lines, microseconds per layer call and the speedup:

        serial:   <us> us/layer-call
     pod_fused:   <us> us/layer-call
    POD speedup over serial: <+x.x>%  (prefill 1024@2048, decode B=16x1024)

A time is the mean of ``--iters`` runs of the ``--layers`` calls, each run
after an L2 flush (``timing.Timer``), divided by ``--layers``; data is
random, from one seeded ``torch.Generator``.  The JAX twin's ``--kv-tile``
(the TPU kernel's key tile) has no counterpart; F's row tables are at
``sub = select_kv_tile(block_tokens, 256)``, as the arena backend's.

    python -m vattention_tpu_torch.microbenchmarks.bench_pod \\
        [--prefill 1024] [--history 2048] [--batch 16] [--ctx 1024]

With ``--cpu`` the plain versions run on the CPU at tiny shapes (prefill
at most 128, history at most 256, batch at most 2, ctx at most 256, 2
layers, at most 2 timed runs) and the times are host wall clock.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vattention_tpu_torch.microbenchmarks.timing import (
    Timer, cap_for_cpu, harness_device, seeded)

Q_TILE = 128  # the q region's pad (config.PREFILL_TOKEN_PAD)
CACHE_LAYERS = 2
CPU_MAX = dict(prefill=128, history=256, batch=2, ctx=256, layers=2, iters=2)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prefill", type=int, default=1024,
                   help="prefill chunk tokens")
    p.add_argument("--history", type=int, default=2048,
                   help="prefill kv history length (incl. chunk)")
    p.add_argument("--batch", type=int, default=16,
                   help="decode batch size")
    p.add_argument("--ctx", type=int, default=1024,
                   help="decode context length per seq")
    p.add_argument("--hq", type=int, default=32)
    p.add_argument("--hkv", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--layers", type=int, default=8,
                   help="chained calls per program")
    p.add_argument("--block-tokens", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="plain versions on the CPU at tiny shapes")
    return p


def bench(args) -> dict:
    """Print the JAX twin's lines; returns {"serial": us, "pod_fused": us}
    per layer call."""
    from vattention_tpu_torch.model_executor.attention.vattn_backend import (
        TABLE_SUB)
    from vattention_tpu_torch.ops.flash_decode import decode_attention
    from vattention_tpu_torch.ops.flash_prefill import (
        MAX_SEGMENTS, segment_prefill_attention)
    from vattention_tpu_torch.ops.pod_fused import pod_attention
    from vattention_tpu_torch.ops.utils import (cdiv, round_up,
                                                select_kv_tile,
                                                tile_rows_from_segments)

    dev = harness_device(args.cpu)
    if args.cpu:
        cap_for_cpu(args, CPU_MAX)
    B, Hq, Hkv, D = args.batch, args.hq, args.hkv, args.head_dim
    L, S, bt = args.layers, MAX_SEGMENTS, args.block_tokens
    sm = D ** -0.5
    Tq = round_up(args.prefill, Q_TILE)
    ctx_pad = round_up(args.ctx, bt)
    hist_pad = round_up(args.history, bt)
    R = hist_pad + ctx_pad * B
    sub = select_kv_tile(bt, TABLE_SUB)
    randn, i32 = seeded(dev)

    kv = randn(CACHE_LAYERS, 2, Hkv, R, D)
    qp = randn(Tq, Hq, D)
    qd = randn(B, Hq, D)

    # prefill seq: one extent at row 0; decode seqs packed after it
    pre_seg_row = np.zeros(S, np.int32)
    pre_seg_cum = np.zeros(S + 1, np.int32)
    pre_seg_cum[1:] = hist_pad
    q_start = args.history - args.prefill
    qinfo = i32([q_start, args.history])
    dec_seg_row = np.zeros((B, S), np.int32)
    dec_seg_cum = np.zeros((B, S + 1), np.int32)
    dec_seg_row[:, 0] = hist_pad + np.arange(B) * ctx_pad
    dec_seg_cum[:, 1:] = ctx_pad
    seqlens = i32(np.full(B, args.ctx))
    seg_row, seg_cum = i32(pre_seg_row), i32(pre_seg_cum)
    pre_rows = i32(tile_rows_from_segments(pre_seg_row[None],
                                           pre_seg_cum[None], sub,
                                           cdiv(hist_pad, sub)))
    dec_rows = i32(tile_rows_from_segments(dec_seg_row, dec_seg_cum, sub,
                                           cdiv(ctx_pad, sub)))
    qt_run = i32([(0, i) for i in range(Tq // Q_TILE)])
    qinfo2 = qinfo.reshape(1, 2)

    def serial():
        for i in range(L):
            segment_prefill_attention(qp, kv, seg_row, seg_cum, qinfo,
                                      i % CACHE_LAYERS, sm_scale=sm)
            decode_attention(qd, kv, dec_rows, seqlens, i % CACHE_LAYERS,
                             sub=sub, sm_scale=sm)

    def fused():
        for i in range(L):
            pod_attention(qp, qd, kv, qt_run, qinfo2, pre_rows, dec_rows,
                          seqlens, i % CACHE_LAYERS, sub=sub,
                          pad_tile=Q_TILE, sm_scale=sm)

    timer = Timer(dev)
    results = {}
    for name, fn in (("serial", serial), ("pod_fused", fused)):
        per = timer(fn, iters=args.iters) * 1e-3 / L
        results[name] = per * 1e6
        print(f"{name:>10}: {per*1e6:8.1f} us/layer-call", flush=True)
    speedup = results["serial"] / results["pod_fused"] - 1.0
    print(f"POD speedup over serial: {speedup*100:+.1f}%  "
          f"(prefill {args.prefill}@{args.history}, "
          f"decode B={args.batch}x{args.ctx})", flush=True)
    return results


def main(argv=None) -> int:
    bench(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
