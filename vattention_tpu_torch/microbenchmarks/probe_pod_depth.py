"""Probe: kernel F (POD) against the serial kernels at a given prefill KV
depth, on the H100.

Twin of ``scripts/probe_pod_depth.py``, which bisected the TPU kernel's
fault boundary (``POD_KV_LEN_LIMIT``).  It runs F once on ``--n-prefill``
prefill runs -- run 0 a ``--prefill``-token chunk at depth ``--depth``,
the others 384-token chunks at depth 4096, each over one extent -- fused
with ``--batch`` decode sequences at depth ``--ctx``, then kernel G on each
run and kernel C on the batch, on the same inputs.  F shares G's and C's
bodies, so its outputs must equal theirs bit for bit: it prints the JAX
twin's lines (the first counts the prefill q tiles and decode splits that
F covers, in place of the TPU schedule's steps) and exits 0 when they are
equal, 1 when not.  With ``--check`` G's and C's outputs are also held
against their plain PyTorch versions on the same inputs
(``timing.check_attention``), each with a line ``# check ...`` before the
verdict; a failure raises.

    python -m vattention_tpu_torch.microbenchmarks.probe_pod_depth \\
        --depth 131072 [--prefill 512] [--batch 8] [--ctx 1024] \\
        [--n-prefill 1] [--check]

With ``--cpu`` the plain versions run on the CPU at tiny shapes (depth at
most 1024, chunks at most 128, batch at most 2, ctx at most 256).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import (
    cap_for_cpu, check_attention, harness_device, seeded)

Q_TILE = 128   # the q region's pad (config.PREFILL_TOKEN_PAD)
ALIGN = 256    # extent alignment of the JAX twin's layout
EXTRA_CHUNK, EXTRA_DEPTH = 384, 4096   # runs 1.. of a multi-run step
CPU_MAX = dict(depth=1024, prefill=128, batch=2, ctx=256)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--depth", type=int, default=16384,
                   help="prefill kv history length (incl. chunk)")
    p.add_argument("--prefill", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ctx", type=int, default=1024)
    p.add_argument("--hq", type=int, default=32)
    p.add_argument("--hkv", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--n-prefill", type=int, default=1,
                   help="number of fused prefill runs (multi-prefill)")
    p.add_argument("--check", action="store_true",
                   help="hold G and C against their plain versions")
    p.add_argument("--cpu", action="store_true",
                   help="plain versions on the CPU at tiny shapes")
    return p


def probe(args) -> bool:
    """Print the JAX twin's lines; True when F equals G then C."""
    from vattention_tpu_torch.model_executor.attention.vattn_backend import (
        TABLE_SUB)
    from vattention_tpu_torch.ops.flash_decode import (decode_attention,
                                                       decode_attention_plain,
                                                       split_count)
    from vattention_tpu_torch.ops.flash_prefill import (
        KERNEL_ROWS, MAX_SEGMENTS, segment_prefill_attention,
        segment_prefill_attention_plain)
    from vattention_tpu_torch.ops.pod_fused import pod_attention
    from vattention_tpu_torch.ops.utils import (cdiv, round_up,
                                                select_kv_tile,
                                                tile_rows_from_segments)

    dev = harness_device(args.cpu)
    extra_chunk, extra_depth = EXTRA_CHUNK, EXTRA_DEPTH
    if args.cpu:
        cap_for_cpu(args, CPU_MAX)
        extra_chunk = min(extra_chunk, CPU_MAX["prefill"])
        extra_depth = min(extra_depth, CPU_MAX["depth"])
    B, Hq, Hkv, D, K = (args.batch, args.hq, args.hkv, args.head_dim,
                        args.n_prefill)
    S = MAX_SEGMENTS
    sm = D ** -0.5
    sub = select_kv_tile(ALIGN, TABLE_SUB)
    ctx_pad = round_up(args.ctx, ALIGN)
    chunks = [args.prefill] + [extra_chunk] * (K - 1)
    depths = [args.depth] + [extra_depth] * (K - 1)
    hist_pads = [round_up(d, ALIGN) for d in depths]
    # run 0's history, then the decode area, then runs 1.. stacked after it
    row0 = np.concatenate([[0], hist_pads[0] + ctx_pad * B
                           + np.cumsum([0] + hist_pads[1:-1])])[:K]
    R = hist_pads[0] + ctx_pad * B + sum(hist_pads[1:])
    randn, i32 = seeded(dev)
    kv = randn(1, 2, Hkv, R, D)
    qd = randn(B, Hq, D)
    pads = [round_up(c, Q_TILE) for c in chunks]
    offs = np.cumsum([0] + pads[:-1]).tolist()
    qp = randn(sum(pads), Hq, D)
    seg_row = np.zeros((K, S), np.int32)
    seg_cum = np.zeros((K, S + 1), np.int32)
    seg_row[:, 0] = row0
    seg_cum[:, 1:] = np.asarray(hist_pads)[:, None]
    qinfo = np.array([(d - c, d) for c, d in zip(chunks, depths)], np.int32)
    qt_run = [(r, i) for r in range(K) for i in range(pads[r] // Q_TILE)]
    dec_seg_row = np.zeros((B, S), np.int32)
    dec_seg_cum = np.zeros((B, S + 1), np.int32)
    dec_seg_row[:, 0] = hist_pads[0] + np.arange(B) * ctx_pad
    dec_seg_cum[:, 1:] = ctx_pad
    seqlens = i32(np.full(B, args.ctx))
    pre_rows = i32(tile_rows_from_segments(seg_row, seg_cum, sub,
                                           cdiv(max(hist_pads), sub)))
    dec_rows = i32(tile_rows_from_segments(dec_seg_row, dec_seg_cum, sub,
                                           cdiv(ctx_pad, sub)))

    # what F covers: B's (q tile, kv head) grid and C's pass-1 splits
    n_pre = sum(pads) // (KERNEL_ROWS[qp.dtype] // (Hq // Hkv)) * Hkv
    n_dec = B * Hkv * split_count(dec_rows, sub)
    print(f"depth={args.depth} K={K} sched={n_pre + n_dec} "
          f"(pre {n_pre} dec {n_dec})", flush=True)
    op, od = pod_attention(qp, qd, kv, i32(qt_run), i32(qinfo), pre_rows,
                           dec_rows, seqlens, 0, sub=sub, pad_tile=Q_TILE,
                           sm_scale=sm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print("fused done", flush=True)

    err_p, same, checks = 0.0, True, []
    for r in range(K):
        sl = slice(offs[r], offs[r] + pads[r])
        g_args = (qp[sl], kv, i32(seg_row[r]), i32(seg_cum[r]),
                  i32(qinfo[r]), 0)
        ref_p = segment_prefill_attention(*g_args, sm_scale=sm)
        if args.check:
            e, rel = check_attention(
                f"probe_pod_depth G, run {r}", ref_p,
                segment_prefill_attention_plain(*g_args, sm_scale=sm))
            checks.append(f"# check G run {r} ({chunks[r]}@{depths[r]}): "
                          f"max abs err {e} (row worst {rel:.5f})")
        got = op[offs[r]:offs[r] + chunks[r]]
        err_p = max(err_p, (got.float() - ref_p[:chunks[r]].float())
                    .abs().max().item())
        same &= torch.equal(got, ref_p[:chunks[r]])
    ref_d = decode_attention(qd, kv, dec_rows, seqlens, 0, sub=sub,
                             sm_scale=sm)
    if args.check:
        e, rel = check_attention(
            "probe_pod_depth C", ref_d, decode_attention_plain(
                qd, kv, dec_rows, seqlens, 0, sub=sub, sm_scale=sm))
        checks.append(f"# check C (B={B}x{args.ctx}): max abs err {e} "
                      f"(row worst {rel:.5f})")
    err_d = (od.float() - ref_d.float()).abs().max().item()
    same &= torch.equal(od, ref_d)
    print(f"max|err| prefill={err_p} decode={err_d}")
    for line in checks:
        print(line)
    print("OK" if same else "MISMATCH", flush=True)
    return same


def main(argv=None) -> int:
    return 0 if probe(parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
