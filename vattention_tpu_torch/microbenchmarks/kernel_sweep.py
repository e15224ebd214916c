"""Kernel-level attention sweep, arena against paged (the paper's Figure 2
analog), on the H100.

Twin of ``scripts/artifact/run_kernel_sweep.py``: the same arguments,
defaults and CSV,

    phase,kernel,ctx,latency_ms,gbps

with, for each context length ctx:

- ``prefill,vattn_contig``: kernel G, one chunk of min(ctx, 2048) tokens
  ending at depth ctx, rows from a one-extent table at arena row 0;
- ``prefill,paged``: kernel H, the same chunk through a block table of
  ``--block-size``-token blocks naming the same rows, so G and H must give
  the same bits (a difference raises);
- ``decode,vattn_contig``: kernel C, ``--batch`` sequences at depth ctx,
  one extent each, its row table at the arena backend's ``sub = 256``;
- ``decode,paged``: kernel C over the same rows through block tables at
  ``sub = block_size``.  At ``--block-size 256`` the two decode rows are
  the same call on equal row tables, so they differ by the timing's noise
  only (and must give the same bits); at smaller blocks they are C at
  ``sub = 256`` against C at ``sub = block_size`` (held to each other
  within the attention tolerance).

With ``--check`` every kernel's output is also held against its plain
PyTorch version on the same inputs (``timing.check_attention``: atol =
rtol = 2e-2, each row within 2^-6 of its largest output), and a line
``# check <kernel> ctx <ctx>: max abs err <e> (row worst <r>)`` follows
the CSV rows of that ctx; a failure raises.

``--window W`` runs every kernel under a sliding window of W positions
(Mistral-7B's is 4096): G and H attend keys p with q - W < p <= q, C the
last W positions of each sequence, and ``gbps`` counts only the K/V rows
that the window lets the call read.

``--kv-dtype fp8`` or ``int8`` runs every kernel over a 1-byte arena (the
seeded values quantized as kernel A writes them, int8 in steps of 0.04
with the step folded into ``sm_scale``), with bf16 queries.

``latency_ms`` is the mean of ``--iters`` calls, each after an L2 flush
(``timing.Timer``); ``gbps`` is the K/V bytes the call must read once over
that time (at the arena's element size).  Data is random, from one seeded ``torch.Generator``.  The TPU
knobs of the JAX twin (``kv_tile``, ``kv_fetch``, ``seq_tile``,
``max_kv_tiles``) have no counterpart: every kernel resolves each key's row
and loops to the live depth.

    python -m vattention_tpu_torch.microbenchmarks.kernel_sweep \\
        [--ctx 1024 2048 4096 8192 16384 32768] [--batch 16] [--window W]
        [--csv out.csv]

With ``--cpu`` the kernels' plain versions run on the CPU at tiny shapes
(ctx at most 512, batch at most 2, at most 2 timed calls) and the times are
host wall clock.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import (
    Timer, cap_for_cpu, check_attention, harness_device, seeded)

HEADER = "phase,kernel,ctx,latency_ms,gbps"
KV_DTYPES = {"bf16": None, "fp8": torch.float8_e4m3fn, "int8": torch.int8}
INT8_STEP = 0.04
CPU_MAX = dict(ctx=512, batch=2, iters=2)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ctx", type=int, nargs="+",
                   default=[1024, 2048, 4096, 8192, 16384, 32768])
    p.add_argument("--batch", type=int, default=16,
                   help="decode batch size")
    p.add_argument("--kv-heads", type=int, default=4)
    p.add_argument("--q-heads", type=int, default=32)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--kv-dtype", choices=sorted(KV_DTYPES), default="bf16",
                   help="the arena's dtype")
    p.add_argument("--window", type=int, default=None,
                   help="sliding window in positions (default: none)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--csv", default=None)
    p.add_argument("--check", action="store_true",
                   help="hold each kernel against its plain version")
    p.add_argument("--cpu", action="store_true",
                   help="plain versions on the CPU at tiny shapes")
    return p


def sweep(args) -> list:
    """Print the CSV; returns its rows (phase, kernel, ctx, ms, gbps)."""
    from vattention_tpu_torch.model_executor.attention.vattn_backend import (
        TABLE_SUB)
    from vattention_tpu_torch.ops.flash_decode import (decode_attention,
                                                       decode_attention_plain)
    from vattention_tpu_torch.ops.flash_prefill import (
        MAX_SEGMENTS, segment_prefill_attention,
        segment_prefill_attention_plain)
    from vattention_tpu_torch.ops.paged_attention import (
        paged_prefill_attention_single, paged_prefill_attention_single_plain,
        paged_tile_rows)
    from vattention_tpu_torch.ops.utils import (cdiv, quantize_kv, round_up,
                                                tile_rows_from_segments)

    dev = harness_device(args.cpu)
    if args.cpu:
        cap_for_cpu(args, CPU_MAX)
    Hq, Hkv, D = args.q_heads, args.kv_heads, args.head_dim
    BT, B, S = args.block_size, args.batch, MAX_SEGMENTS
    sm = D ** -0.5
    win = dict(window=args.window)
    # each decode sequence owns `stride` rows: its context, then one block
    stride = round_up(max(args.ctx), BT) + BT
    R = max(stride, B * stride)
    randn, i32 = seeded(dev)
    checks = []

    def check(kernel, ctx, got, plain):
        if args.check:
            err, rel = check_attention(f"kernel_sweep {kernel} ctx {ctx}",
                                       got, plain(), scale=out_scale)
            checks.append(f"# check {kernel} ctx {ctx}: max abs err {err} "
                          f"(row worst {rel:.5f})")

    kv = randn(1, 2, Hkv, R, D)
    arena = KV_DTYPES[args.kv_dtype]
    out_scale = 1.0           # an int8 arena's outputs count in its steps
    if arena is not None:
        kv = quantize_kv(kv, arena, INT8_STEP)
        if arena == torch.int8:
            sm *= INT8_STEP
            out_scale = INT8_STEP
    es = kv.element_size()
    timer = Timer(dev)
    rows = []

    def emit(phase, kernel, ctx, fn, nbytes):
        ms = timer(fn, iters=args.iters)
        gbps = nbytes / (ms * 1e-3) / 1e9
        rows.append((phase, kernel, ctx, ms, gbps))
        print(f"{phase},{kernel},{ctx},{ms:.3f},{gbps:.0f}", flush=True)

    print(HEADER, flush=True)
    for ctx in args.ctx:
        # ---- prefill: one sequence, its last min(ctx, 2048) tokens ------ #
        Tq = min(ctx, 2048)
        q = randn(Tq, Hq, D)
        seg_row = i32(np.zeros(S))
        seg_cum = i32([0] + [ctx] * S)
        qinfo = i32([ctx - Tq, ctx])
        table = i32(np.arange(cdiv(ctx, BT)))

        def g():
            return segment_prefill_attention(q, kv, seg_row, seg_cum, qinfo,
                                             0, sm_scale=sm, **win)

        def h():
            return paged_prefill_attention_single(q, kv, table, qinfo, 0,
                                                  block_size=BT, sm_scale=sm,
                                                  **win)

        got_g, got_h = g(), h()
        if not torch.equal(got_g, got_h):
            raise AssertionError(
                f"kernel_sweep: G and H differ at ctx {ctx} on the same rows")
        check("G", ctx, got_g, lambda: segment_prefill_attention_plain(
            q, kv, seg_row, seg_cum, qinfo, 0, sm_scale=sm, **win))
        check(f"H (bs {BT})", ctx, got_h,
              lambda: paged_prefill_attention_single_plain(
                  q, kv, table, qinfo, 0, block_size=BT, sm_scale=sm, **win))
        # K+V rows the chunk attends, read once
        keys = min(ctx, Tq + args.window - 1) if args.window else ctx
        pre_bytes = keys * Hkv * D * es * 2
        emit("prefill", "vattn_contig", ctx, g, pre_bytes)
        emit("prefill", "paged", ctx, h, pre_bytes)

        # ---- decode: B sequences at this context ------------------------ #
        qd = randn(B, Hq, D)
        seqlens = i32(np.full(B, ctx))
        sub = TABLE_SUB
        srow = np.zeros((B, S), np.int32)
        scum = np.zeros((B, S + 1), np.int32)
        srow[:, 0] = np.arange(B) * stride
        scum[:, 1:] = ctx
        vattn_rows = i32(tile_rows_from_segments(srow, scum, sub,
                                                 cdiv(ctx, sub)))
        btab = i32(np.arange(B)[:, None] * (stride // BT)
                   + np.arange(cdiv(ctx, BT))[None, :])
        paged_rows = paged_tile_rows(btab, seqlens, BT)

        def c_vattn():
            return decode_attention(qd, kv, vattn_rows, seqlens, 0, sub=sub,
                                    sm_scale=sm, **win)

        def c_paged():
            return decode_attention(qd, kv, paged_rows, seqlens, 0, sub=BT,
                                    sm_scale=sm, **win)

        got_v, got_p = c_vattn(), c_paged()
        if sub != BT:
            check_attention(f"kernel_sweep: decode at sub {sub} against "
                            f"sub {BT}, ctx {ctx}", got_v, got_p,
                            scale=out_scale)
        elif not torch.equal(got_v, got_p):
            raise AssertionError(f"kernel_sweep: vattn and paged decode "
                                 f"differ at ctx {ctx} on the same rows")
        check(f"C (sub {sub})", ctx, got_v, lambda: decode_attention_plain(
            qd, kv, vattn_rows, seqlens, 0, sub=sub, sm_scale=sm, **win))
        check(f"C (sub {BT})", ctx, got_p, lambda: decode_attention_plain(
            qd, kv, paged_rows, seqlens, 0, sub=BT, sm_scale=sm, **win))
        depth = min(ctx, args.window) if args.window else ctx
        dec_bytes = B * depth * Hkv * D * es * 2
        emit("decode", "vattn_contig", ctx, c_vattn, dec_bytes)
        emit("decode", "paged", ctx, c_paged, dec_bytes)
        for line in checks:
            print(line, flush=True)
        checks.clear()

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(HEADER + "\n")
            for r in rows:
                f.write(f"{r[0]},{r[1]},{r[2]},{r[3]:.3f},{r[4]:.0f}\n")
        print(f"wrote {args.csv}", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    sweep(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
