"""Time the prefill body's kernels (B, E, F, G, H) call by call at the
shapes of chip_smoke (a) and of deep chunks.

    python -m vattention_tpu_torch.microbenchmarks.bench_prefill \\
        [--case a deep32k deep64k] [--arena bf16 e4m3 int8] [--calls 20]

Yi-6B-200K's attention heads (32 q, 4 kv, D 128), bf16 queries.  Cases
(``CASES``: one run of ``chunk`` query tokens ending at depth
``kv_len``):

- ``a``: chunk 512 at kv_len 4096, as chip_smoke (a) and ``PERF.md``'s
  per-call table: B over two extents of 2048-token blocks through a row
  table of 256-row entries (fa_vattn_2mb's), E and H over a seeded
  permutation of 256-token blocks, G over 8 extents of 512 tokens, F with
  a decode batch of 8 slots at depths 0 to 4096 beside the chunk;
- ``deep32k``, ``deep64k``: chunk 2048 at depth 32,768 and 65,536, a
  serving chunk deep in a long prompt: B over one contiguous extent (a
  vAttention request's rows) and G over the same rows.

Over a 1-byte arena (``--arena e4m3`` or ``int8``: the seeded values
quantized as kernel A writes them, int8 in steps of 0.04 folded into
``sm_scale``) only B runs.  Each kernel is first checked: at ``a`` B
against its plain version (``timing.check_attention``), E, G and H
against their plain versions and F against B then C, bit for bit; at
depth G against B, bit for bit.  Then ``--calls`` single calls of each
are timed with ``timing.Timer`` (each after an L2 flush), in turns.  One
line per kernel: case, arena, min / median / max ms, the bound
(``timing.bound``: the query and output bytes and every K/V row read
once, against 4 Hq D FLOPs per attended (query, key) pair; F adds its
decode slots) and the median's share of it.  It uses only the kernels'
public wrappers, so it times an earlier checkout's kernels too when that
checkout is first on ``PYTHONPATH``.

With ``--device cpu`` the plain versions run at tiny shapes (every depth
cut to 512, chunks to 128, 4 q heads on 1 kv head) and times are host
wall clock; without a GPU it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import (Timer, bound,
                                                         check_attention,
                                                         harness_device)
from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                      paged_attention, pod_fused)
from vattention_tpu_torch.ops.utils import (cdiv, quantize_kv,
                                            tile_rows_from_segments)

# name: (chunk, kv_len)
CASES = {"a": (512, 4096), "deep32k": (2048, 32768),
         "deep64k": (2048, 65536)}
ARENAS = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
          "int8": torch.int8}
INT8_STEP = 0.04          # KV_INT8_SCALE's default
HEADS = dict(HQ=32, HKV=4, D=128)
CPU_HEADS = dict(HQ=4, HKV=1, D=128)
CPU_MAX = dict(chunk=128, kv_len=512, calls=2)
BT = 2048                 # fa_vattn_2mb's block tokens at Yi's kv heads
SUB = 256                 # its row-table entry
PAD = 128                 # the scheduler's q charge unit
BS = 256                  # E's and H's block size
DEC_DEPTHS = [0, 1, 17, 512, 1000, 2048, 3000, 4096]


def spread(times: List[float]) -> str:
    s = sorted(times)
    return f"{s[0]:.4f} / {s[len(s) // 2]:.4f} / {s[-1]:.4f}"


def one_extent_rows(extents, n_sub: int, dev) -> torch.Tensor:
    """B's row table ``[1, n_sub]`` of one run over ``extents`` [(row,
    tokens), ...] at ``SUB``-row entries."""
    seg_row = np.zeros((1, 8), np.int32)
    seg_cum = np.zeros((1, 9), np.int32)
    t = 0
    for j, (row, n) in enumerate(extents):
        seg_row[0, j], seg_cum[0, j] = row, t
        t += n
    seg_cum[0, len(extents):] = t
    return torch.from_numpy(
        tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)).to(dev)


def same(what: str, got, name: str, ref, cpu: bool) -> None:
    """``got`` equal to ``ref`` bit for bit on the card (the same body);
    the plain versions on the CPU within the attention tolerance."""
    if cpu:
        check_attention(f"{what} against {name}", got, ref)
    elif not torch.equal(got, ref):
        raise AssertionError(f"{what} differs from {name}")


def prefill_bound(chunk: int, kv_len: int, heads, kv_es: int,
                  dec_depths=()):
    """(bound ms, by) of one run of ``chunk`` tokens ending at ``kv_len``
    (and decode slots at ``dec_depths``)."""
    hq, hkv, d = heads["HQ"], heads["HKV"], heads["D"]
    q0 = kv_len - chunk
    pairs = chunk * q0 + chunk * (chunk + 1) // 2
    n_dec = len(dec_depths)
    return bound(2 * (chunk + n_dec) * hq * d * 2
                 + (kv_len + sum(dec_depths)) * 2 * hkv * d * kv_es,
                 4 * hq * d * (pairs + sum(dec_depths)))


def case_calls(case: str, arena: str, dev, cpu: bool):
    """The checked calls of one case over one arena: a dict name ->
    (zero-argument call, bound ms, bound by)."""
    heads = CPU_HEADS if cpu else HEADS
    hq, hkv, d = heads["HQ"], heads["HKV"], heads["D"]
    chunk, kv_len = CASES[case]
    if cpu:
        chunk, kv_len = min(chunk, CPU_MAX["chunk"]), min(kv_len,
                                                          CPU_MAX["kv_len"])
    q0 = kv_len - chunk
    rows = max(25 * BT, kv_len + 2 * BT)
    gen = torch.Generator(device=dev).manual_seed(22)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev,
                                   dtype=torch.float32).to(torch.bfloat16)
    cache = randn(1, 2, hkv, rows, d)
    kv_dtype = ARENAS[arena]
    step = INT8_STEP if kv_dtype == torch.int8 else None
    if kv_dtype != torch.bfloat16:
        cache = quantize_kv(cache, kv_dtype, step)
    sm = d ** -0.5 * (step or 1.0)
    kv_es = cache.element_size()
    q = randn(chunk, hq, d)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    qt_run = i32([[0, i] for i in range(chunk // PAD)])
    qinfo = i32([[q0, kv_len]])
    n_sub = cdiv(kv_len, SUB)
    if case == "a":   # two extents of 2048-token blocks, as (a)'s case 1
        ext = [(2 * BT, kv_len // 4), (6 * BT, kv_len - kv_len // 4)]
    else:
        ext = [(BT, kv_len)]
    trows = one_extent_rows(ext, n_sub, dev)
    kw = dict(sub=SUB, pad_tile=PAD, sm_scale=sm)
    b_args = (q, cache, qt_run, qinfo, trows, 0)
    b = flash_prefill.prefill_attention(*b_args, **kw)
    b_bound = prefill_bound(chunk, kv_len, heads, kv_es)
    calls = {"B": (lambda: flash_prefill.prefill_attention(*b_args, **kw),
                   *b_bound)}
    if case == "a":
        check_attention(f"{case} B over {arena}",
                        b, flash_prefill.prefill_attention_plain(*b_args,
                                                                 **kw),
                        scale=step or 1.0)
    if kv_dtype != torch.bfloat16:
        return calls

    # G over the same rows at depth, 8 extents of kv_len / 8 at (a)
    info = qinfo[0].clone()
    if case == "a":
        part = kv_len // 8
        g_ext = [(BT * (3 * j + 1), part) for j in range(8)]
    else:
        g_ext = ext
    seg_row = i32([r for r, _ in g_ext])
    seg_cum = i32(np.concatenate([[0], np.cumsum([n for _, n in g_ext])]))
    g_args = (q, cache, seg_row, seg_cum, info, 0)
    g = flash_prefill.segment_prefill_attention(*g_args, sm_scale=sm)
    calls["G"] = (lambda: flash_prefill.segment_prefill_attention(
        *g_args, sm_scale=sm), *b_bound)
    if case != "a":
        same(f"{case}: G", g, "B on the same rows", b, cpu)
        return calls
    check_attention(f"{case} G", g,
                    flash_prefill.segment_prefill_attention_plain(
                        *g_args, sm_scale=sm))

    # E and H over a permutation of 256-token blocks
    perm = np.random.default_rng(22).permutation(rows // BS)
    table = i32(perm[:cdiv(kv_len, BS)])
    e_args = (q, cache, qt_run, qinfo, table[None], 0)
    ekw = dict(block_size=BS, pad_tile=PAD, sm_scale=sm)
    e = paged_attention.paged_prefill_attention(*e_args, **ekw)
    check_attention(f"{case} E", e,
                    paged_attention.paged_prefill_attention_plain(*e_args,
                                                                  **ekw))
    h_args = (q, cache, table, info, 0)
    hkw = dict(block_size=BS, sm_scale=sm)
    h = paged_attention.paged_prefill_attention_single(*h_args, **hkw)
    same(f"{case}: H", h, "E on one run", e, cpu)
    calls["E"] = (lambda: paged_attention.paged_prefill_attention(
        *e_args, **ekw), *b_bound)
    calls["H"] = (lambda: paged_attention.paged_prefill_attention_single(
        *h_args, **hkw), *b_bound)

    # F: the chunk beside a decode batch, against B then C
    depths = [min(x, kv_len) for x in DEC_DEPTHS]
    dec_ext = [[(BT * (2 * j + 1), n)] if n else [] for j, n in
               enumerate(depths)]
    drows = torch.cat([one_extent_rows(x, n_sub, dev) if x else
                       torch.zeros((1, n_sub), dtype=torch.int32, device=dev)
                       for x in dec_ext])
    qd = randn(len(depths), hq, d)
    seqlens = i32(depths)
    f_args = (q, qd, cache, qt_run, qinfo, trows, drows, seqlens, 0)
    f_p, f_d = pod_fused.pod_attention(*f_args, **kw)
    c = flash_decode.decode_attention(qd, cache, drows, seqlens, 0, sub=SUB,
                                      sm_scale=sm)
    same(f"{case}: F's prefill output", f_p, "B", b, cpu)
    same(f"{case}: F's decode output", f_d, "C", c, cpu)
    calls["F"] = (lambda: pod_fused.pod_attention(*f_args, **kw),
                  *prefill_bound(chunk, kv_len, heads, kv_es, depths))
    return calls


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--case", nargs="+", choices=list(CASES),
                   default=list(CASES))
    p.add_argument("--arena", nargs="+", choices=list(ARENAS),
                   default=list(ARENAS))
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def run(args) -> None:
    dev = harness_device(args.device == "cpu")
    cpu = dev.type == "cpu"
    if cpu:
        args.calls = min(args.calls, CPU_MAX["calls"])
    timer = Timer(dev)
    print("kernel,case,arena,ms min / median / max,bound ms,bound by,"
          "% of bound", flush=True)
    for case in args.case:
        for arena in args.arena:
            if arena != "bf16" and case != "a":
                continue
            calls = case_calls(case, arena, dev, cpu)
            if not cpu:
                torch.cuda.synchronize()
            ms = {k: [] for k in calls}
            for _ in range(args.calls):
                for k, (call, _, _) in calls.items():
                    ms[k].append(timer(call, iters=1, warmup=0))
            for k, (_, b_ms, by) in calls.items():
                med = sorted(ms[k])[len(ms[k]) // 2]
                print(f"{k},{case},{arena},{spread(ms[k])},{b_ms:.5f},{by},"
                      f"{100 * b_ms / med:.1f}", flush=True)


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
