#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vattention_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's eight CUDA kernels (A-H) from the six sources of
``vattention_tpu_torch/csrc`` (one nvcc per source, in parallel) and
prints ptxas's registers and spills of kernels B, C, E, F, G and H, with
the shared memory per block of the bf16 prefill body's instances (and any
ptxas note on wgmma), then runs its phases; any failure raises and the
script exits non-zero without printing a result.

(a) Kernels at the main paths' shapes (Yi-6B-200K geometry, bf16, the
    2048-token blocks the allocator gives fa_vattn_2mb; for the paged
    prefill kernel E, blocks of 16 and 256 tokens drawn as a seeded
    permutation of the pool, every table entry past a run's last valid
    block set to 2**30): each kernel is held against its plain PyTorch
    version on the same inputs and timed beside that version, a one-call
    library yardstick and its roofline bound.  E is also held against
    kernel B on the same rows (the same body: expected bit for bit), and
    kernel C is timed over 16-token blocks as the paged engine calls it.
    Kernel F (POD) runs B's chunk 512 at kv_len 4096 (and then B's
    multi-run case) with C's batch of 8 slots in one launch; it is held
    against its plain version with B's and C's tolerances and against B
    and C on the same inputs (the same bodies: expected bit for bit), and
    timed beside B then C launched serially in one loop (no single
    PyTorch call computes both outputs, so F has no library time; the two
    SDPA calls' sum is logged), and each of its roles alone (the other
    role's blocks given no work) beside B or C alone.  The timer's mode
    (``microbenchmarks/timing.py``, ``VATTN_TIMER``) is logged first.  The shared prefill body's edge cases
    (``microbenchmarks/prefill_edges.py``, at Yi geometry: kv_len 1-4133,
    q_start 40, 56 and 60 mod 64, the empty run, E and H over 16-token
    blocks with poisoned tails, G over unaligned extents) are held against
    the plain versions and E = B, F = B and C, G = B, H = E bit for bit.
    Then the body at depth: G and H (16-token blocks) at chunk 2048 at
    kv_len 32768, each held against its plain version and timed beside
    one SDPA call on the same gathered K/V and its bound (logged only).
    Tolerances: kv_append and arena_relocate bit for bit; prefill and
    decode attention within atol = rtol = 2e-2 in bf16 (one bf16 rounding
    of outputs of magnitude ~1, summed in another order) and, for each
    output row (a query token or decode slot), a max error within 2^-6 of
    that row's largest output (deep outputs are small, so 2e-2 alone
    would let a wrong kernel through).
(b) f32 parity: tiny-llama-debug, float32, sarathi chunk 128 on the
    two-prompt workload of tests/test_e2e.py, through fa_vattn, then
    (b') fa_paged_16 and (b'') fa_pod (whose mixed step must run through
    kernel F); the engine's greedy tokens must equal a dense
    full-recompute reference's.
(c) Serving at full width: yi-6b-200k (32 layers, bf16, random weights
    from a seed) through LLMEngine with fa_vattn_2mb, sarathi chunk 512,
    max_model_len 8192, max_batch_size 8: 8 requests of seeded prompt
    lengths in [1024, 4096] and 32 greedy tokens each, the launch counts
    zeroed just before and read just after.  kv_append, prefill and
    decode attention must have launched, the paged prefill not;
    arena_relocate launches once per relocation the allocator plans, and
    at these sizes it plans none (a request spans at most 4 blocks and
    may hold 8 extents), so phase (a) is what holds it.  Then 2 short
    prompts whose first token is held against a dense float32 reference
    on the same bf16 weights.  Last, 4 more requests run under
    torch.profiler for a breakdown of device time and idle share, lines
    "(p)".
(d) The same through a fresh engine with fa_paged_256 (the (c) engine
    freed first): kv_append, paged prefill and decode attention must
    have launched, prefill_attention and arena_relocate not; the tokens
    are compared with (c)'s and the short prompts held as in (c).
(e) The same through a fresh engine with fa_pod (2 MB pages, the (c)
    arena; the (d) engine freed first): kernel F, A, B and C must have
    launched, E and D not, and since the schedule is (c)'s, F's launches
    plus B's must equal B's in (c), and F's plus C's C's in (c); the tokens
    are compared with (c)'s and the short prompts held as in (c).
    Kernels G and H must not launch in (c), (d) or (e): no serving path
    runs them.
(f) The kernel-level A/B entry points (``vattention_tpu_torch/
    microbenchmarks``) at Yi-6B's attention geometry in bf16, G's and H's
    launch counts zeroed just before and read just after: kernel_sweep at
    ctx 1024-32768 with blocks of 256 (the JAX default) and then 16 tokens
    (vLLM's default block), bench_pagesize, bench_pod and probe_pod_depth
    at depths 16384, 32768, 65536 and 131072 and with 3 prefill runs at
    16384.  The sweep and the probe run with ``--check``: every G, H and C
    output they make (G and H at chunk 2048 to depth 32768, G at chunk 512
    to depth 131072) is held against its plain version on the same inputs
    with (a)'s tolerances, the plain prefill run 256 query tokens at a
    time.  Besides, G must equal H in the sweep and each probe's F must
    equal G then C, bit for bit.

Kernels G (single-run arena prefill, rows from the extent table) and H
(single-run paged prefill) run only in (a) and (f).  In (a) each is held
against its plain version at B's shape (chunk 512 at kv_len 4096): G over
8 extents of 512 tokens at 2048-token block starts, and against B on the
same rows; H over a seeded permutation of 16- and 256-token blocks with
its tail poisoned to 2**30, and against E on one run (both expected bit for
bit).

Prints the phase results, then ``{"kernels": [...]}`` (A-H; G's and H's
launches from (f)), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from vattention_tpu_torch.microbenchmarks.prefill_edges import (
        check_prefill_edges)
    from vattention_tpu_torch.microbenchmarks.timing import (
        ATTN_TOL, Timer, bound, check_attention, seeded)
except ImportError as e:  # chip_smoke.py without the port beside it
    sys.exit(f"chip_smoke: the port is not importable here ({e})")

PREFILL_TOL = DECODE_TOL = ATTN_TOL
LOGIT_GAP_TOL = 0.25          # engine token's logit vs the reference top
YI = dict(L=32, HQ=32, HKV=4, D=128)


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------- #
# (a) kernels
# --------------------------------------------------------------------- #
def kernel_phase(dev):
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator
    from vattention_tpu_torch.ops import (arena_copy, cache_append,
                                          flash_decode, flash_prefill)
    from vattention_tpu_torch.ops.utils import (select_kv_tile,
                                                tile_rows_from_segments)

    L, HQ, HKV, D = YI["L"], YI["HQ"], YI["HKV"], YI["D"]
    G = HQ // HKV
    dt = torch.bfloat16
    es = 2
    sm = D ** -0.5
    probe = VAttentionAllocator()
    probe.init_kvcache(num_layers=L, num_kv_heads=HKV, head_size=D,
                       max_batch_size=8, max_context_length=8192,
                       dtype_bytes=es, page_size=2 * 2**20)
    bt = probe.block_tokens                   # 2048 for fa_vattn_2mb
    sub = select_kv_tile(bt, 256)
    R = 24 * bt
    n_sub = 8192 // sub                       # row tables of max_model_len 8192
    randn, _ = seeded(dev)
    cache = randn(L, 2, HKV, R + bt, D)
    timer = Timer(dev)
    log(f"(a) timer: {timer.mode}")
    results = []

    def table(extents_per_seq):
        S = 8
        seg_row = np.zeros((len(extents_per_seq), S), np.int32)
        seg_cum = np.zeros((len(extents_per_seq), S + 1), np.int32)
        for b, ext in enumerate(extents_per_seq):
            t = 0
            for j, (row, n) in enumerate(ext):
                seg_row[b, j], seg_cum[b, j] = row, t
                t += n
            seg_cum[b, len(ext):] = t
        return torch.from_numpy(
            tile_rows_from_segments(seg_row, seg_cum, sub, n_sub)).to(dev)

    # -- A: kv_append, 512 prefill rows (two extent runs) + 8 decode rows
    layer = 5
    T = 512 + 8
    rows = np.full(T, -1, np.int32)
    rows[:300] = np.arange(3 * bt + 1000, 3 * bt + 1300)
    rows[300:480] = np.arange(9 * bt, 9 * bt + 180)      # 480..511: padding
    rows[512:518] = [bt * i + 17 * i for i in (11, 12, 13, 14, 15, 16)]
    k, v = randn(T, HKV, D), randn(T, HKV, D)
    rows_d = torch.from_numpy(rows).to(dev)
    expect = cache.clone()
    cache_append.kv_append_plain(expect, k, v, rows_d, layer)
    got = cache.clone()
    cache_append.kv_append(got, k, v, rows_d, layer)
    torch.cuda.synchronize()
    if not torch.equal(got, expect):
        raise AssertionError("kv_append differs from its plain version")
    del expect
    valid = rows >= 0
    nvalid = int(valid.sum())
    rv = torch.from_numpy(rows[valid].astype(np.int64)).to(dev)
    kv_src = torch.stack([k[torch.from_numpy(valid).to(dev)],
                          v[torch.from_numpy(valid).to(dev)]]).transpose(1, 2)
    b_ms, b_by = bound(nvalid * 2 * HKV * D * es * 2 + T * 4, 0)
    results.append(dict(
        name="kv_append", route="cuda",
        source="vattention_tpu_torch/csrc/kv_append.cu",
        replaces="vattention_tpu/ops/cache_append.py:152,274",
        max_abs_err=0.0,
        ms=timer(lambda: cache_append.kv_append(got, k, v, rows_d, layer)),
        plain_ms=timer(lambda: cache_append.kv_append_plain(
            got, k, v, rows_d, layer)),
        library_ms=timer(lambda: got[layer].index_copy_(2, rv, kv_src)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"T={T} ({nvalid} valid) Hkv={HKV} D={D} bf16"))
    del got

    # -- B: prefill; case 1 = chunk 512 at kv_len 4096 over two extents
    pad = 128
    ext1 = [(2 * bt, bt), (6 * bt, 2 * bt)]
    q = randn(512, HQ, D)
    qt_run = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                          device=dev)
    qinfo = torch.tensor([[3584, 4096], [0, 0]], dtype=torch.int32,
                         device=dev)
    trows = table([ext1, []])
    args = (q, cache, qt_run, qinfo, trows, layer)
    kw = dict(sub=sub, pad_tile=pad, sm_scale=sm)
    got = flash_prefill.prefill_attention(*args, **kw)
    ref = flash_prefill.prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = check_attention("prefill case 1", got, ref, PREFILL_TOL)
    checks = [f"chunk 512 at kv_len 4096: {err} (row worst {rel:.5f})"]
    # case 2: 3 runs + the empty padding run in one launch
    ext2 = [[(bt, 1024)], [(4 * bt, bt), (12 * bt, bt)], [(14 * bt, 64)], []]
    qinfo2 = torch.tensor([[0, 128], [2000, 2100], [0, 60], [0, 0]],
                          dtype=torch.int32, device=dev)
    qt_run2 = torch.tensor([[0, 0], [1, 0], [2, 0], [3, 0]],
                           dtype=torch.int32, device=dev)
    args2 = (q, cache, qt_run2, qinfo2, table(ext2), layer)
    got2 = flash_prefill.prefill_attention(*args2, **kw)
    ref2 = flash_prefill.prefill_attention_plain(*args2, **kw)
    torch.cuda.synchronize()
    if got2[384:].abs().max().item() != 0.0:
        raise AssertionError("prefill: the empty run's tile is not zero")
    for lo, n, depth in ((0, 128, 128), (128, 100, 2100), (256, 60, 60)):
        e, r = check_attention(f"prefill case 2, run at {lo}",
                               got2[lo:lo + n], ref2[lo:lo + n], PREFILL_TOL)
        checks.append(f"run of {n} rows to depth {depth}: {e} "
                      f"(row worst {r:.5f})")
        err = max(err, e)
    log("(a) prefill_attention max abs err per case: " + "; ".join(checks))
    # yardstick: SDPA over the case-1 K/V gathered once, bottom-right causal
    pos = torch.arange(4096, device=dev)
    grow = trows[0].long()[pos // sub] + pos % sub
    kg = cache[layer, 0][:, grow][None]          # [1, Hkv, 4096, D]
    vg = cache[layer, 1][:, grow][None]
    qg = q.transpose(0, 1)[None]                 # [1, Hq, 512, D]
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = int(mask.sum().item())
    b_ms, b_by = bound((2 * 512 * HQ * D + 4096 * 2 * HKV * D) * es,
                       4 * HQ * D * pairs)
    results.append(dict(
        name="prefill_attention", route="cuda",
        source="vattention_tpu_torch/csrc/prefill_attention.cu",
        replaces="vattention_tpu/ops/flash_prefill.py:273",
        max_abs_err=err,
        ms=timer(lambda: flash_prefill.prefill_attention(*args, **kw)),
        plain_ms=timer(lambda: flash_prefill.prefill_attention_plain(
            *args, **kw), iters=3),
        library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                      enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"chunk 512 at kv_len 4096, Hq={HQ} Hkv={HKV} D={D} bf16"))
    del kg, vg

    # -- C: decode, B=8 at depths 0..4096
    seqlens_l = [0, 1, 17, 512, 1000, 2048, 3000, 4096]
    ext_d = [[], [(0, bt)], [(bt, bt)], [(2 * bt, bt)], [(3 * bt, bt)],
             [(4 * bt, bt)], [(5 * bt, bt), (15 * bt, bt)],
             [(7 * bt, 2 * bt)]]
    qd = randn(8, HQ, D)
    seqlens = torch.tensor(seqlens_l, dtype=torch.int32, device=dev)
    trows_d = table(ext_d)
    dargs = (qd, cache, trows_d, seqlens, layer)
    dkw = dict(sub=sub, sm_scale=sm)
    got = flash_decode.decode_attention(*dargs, **dkw)
    ref = flash_decode.decode_attention_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
        raise AssertionError("decode: the seqlen-0 slot is not zero")
    err, checks = 0.0, []
    for b, n in enumerate(seqlens_l):
        if n:
            e, r = check_attention(f"decode slot {b} at depth {n}",
                                   got[b:b + 1], ref[b:b + 1], DECODE_TOL)
            checks.append(f"depth {n}: {e} (row worst {r:.5f})")
            err = max(err, e)
    log("(a) decode_attention max abs err per slot: " + "; ".join(checks))
    kpad = torch.zeros((8, HKV, 4096, D), dtype=dt, device=dev)
    vpad = torch.zeros_like(kpad)
    for b, n in enumerate(seqlens_l):
        if n:
            r = trows_d[b].long()[torch.arange(n, device=dev) // sub] + \
                torch.arange(n, device=dev) % sub
            kpad[b, :, :n] = cache[layer, 0][:, r]
            vpad[b, :, :n] = cache[layer, 1][:, r]
    dmask = (torch.arange(4096, device=dev)[None, :]
             < seqlens[:, None])[:, None, None, :]
    b_ms, b_by = bound((sum(seqlens_l) * 2 * HKV * D + 2 * 8 * HQ * D) * es
                       + 8 * 4, 4 * HQ * D * sum(seqlens_l))
    results.append(dict(
        name="decode_attention", route="cuda",
        source="vattention_tpu_torch/csrc/decode_attention.cu",
        replaces="vattention_tpu/ops/flash_decode.py:157",
        max_abs_err=err,
        ms=timer(lambda: flash_decode.decode_attention(*dargs, **dkw)),
        plain_ms=timer(lambda: flash_decode.decode_attention_plain(
            *dargs, **dkw), iters=3),
        library_ms=timer(lambda: sdpa(qd[:, :, None], kpad, vpad,
                                      attn_mask=dmask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=8 depths {seqlens_l}, Hq={HQ} Hkv={HKV} D={D} bf16"))
    del kpad, vpad

    results.append(pod_kernel(timer, args, args2, dargs, seqlens_l, sub,
                              results[-2]["library_ms"]
                              + results[-1]["library_ms"]))
    results.append(paged_kernels(dev, cache, R, timer, randn, layer))
    results += single_run_kernels(dev, cache, R, bt, sub, n_sub, timer,
                                  randn, layer)
    err, rel = check_prefill_edges(cache, HQ, layer)
    log("(a) prefill body edge cases (kv_len 1, 63, 64, 65, 200, 4133; "
        "q_start 40, 56, 60 mod 64; the empty run; B over 16-token block "
        "tables with poisoned tails and over unaligned extents): max abs err "
        f"{err} (row worst {rel:.5f}); E = B, F = B and C, G = B, H = E bit "
        "for bit")
    long_context(dev, cache, R, bt, timer, randn, layer)

    # -- D: a chained plan from the allocator in strict mode
    plan, live = strict_relocation_plan(L, HKV, D, es)
    n_moves = len(plan.moves)
    src = torch.tensor([m.src for m in plan.moves], dtype=torch.int32,
                       device=dev)
    dst = torch.tensor([m.dst for m in plan.moves], dtype=torch.int32,
                       device=dev)
    before = cache.clone()
    expect = cache.clone()
    arena_copy.arena_relocate_plain(expect, src, dst, n_moves, bt)
    arena_copy.arena_relocate(cache, src, dst, n_moves, bt)
    torch.cuda.synchronize()
    if not torch.equal(cache, expect):
        raise AssertionError("arena_relocate differs from its plain version")
    del expect
    for old_rows, new_rows in live:
        o = torch.from_numpy(old_rows).to(dev)
        nw = torch.from_numpy(new_rows).to(dev)
        if not torch.equal(before[:, :, :, o], cache[:, :, :, nw]):
            raise AssertionError("a live slot's KV did not survive relocation")
    del before
    moves = [(m.src, m.dst) for m in plan.moves]

    def library_moves():
        for s_, d_ in moves:
            cache[:, :, :, d_ * bt:(d_ + 1) * bt].copy_(
                cache[:, :, :, s_ * bt:(s_ + 1) * bt])

    b_ms, b_by = bound(n_moves * L * 2 * HKV * bt * D * es * 2
                       + n_moves * 8, 0)
    results.append(dict(
        name="arena_relocate", route="cuda",
        source="vattention_tpu_torch/csrc/arena_relocate.cu",
        replaces="vattention_tpu/ops/arena_copy.py:59",
        max_abs_err=0.0,
        ms=timer(lambda: arena_copy.arena_relocate(cache, src, dst, n_moves,
                                                   bt)),
        plain_ms=timer(lambda: arena_copy.arena_relocate_plain(
            cache, src, dst, n_moves, bt)),
        library_ms=timer(library_moves),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{n_moves} chained moves {moves} of {bt}-row blocks, "
              f"L={L} Hkv={HKV} D={D} bf16"))
    del cache
    torch.cuda.empty_cache()
    for r in results:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"(a) {r['name']}: {r['shape']}: max_abs_err {r['max_abs_err']}"
            f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    return results


def pod_kernel(timer, pre1, pre2, dec, depths, sub, sdpa_ms):
    """(a) for kernel F: each of kernel B's two cases (``pre1``: chunk 512
    at kv_len 4096; ``pre2``: 3 runs and the empty run) fused with kernel
    C's batch (``dec``) in one launch, held against F's plain version and
    against B and C on the same inputs; F timed on ``pre1`` beside B then
    C.  ``sdpa_ms`` is the sum of B's and C's SDPA times."""
    from vattention_tpu_torch.ops import flash_decode, flash_prefill, pod_fused

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    es = 2
    qd, cache, trows_d, seqlens, layer = dec
    sm = D ** -0.5
    kw = dict(sub=sub, pad_tile=128, sm_scale=sm)
    dkw = dict(sub=sub, sm_scale=sm)
    err, checks = 0.0, []
    # (prefill args, real row ranges, first row of the empty run's tile)
    for pre, ranges, empty in ((pre1, [(0, 512)], None),
                               (pre2, [(0, 128), (128, 100), (256, 60)], 384)):
        q, _, qt_run, qinfo, trows, _ = pre
        fargs = (q, qd, cache, qt_run, qinfo, trows, trows_d, seqlens, layer)
        got_p, got_d = pod_fused.pod_attention(*fargs, **kw)
        ref_p, ref_d = pod_fused.pod_attention_plain(*fargs, **kw)
        got_b = flash_prefill.prefill_attention(*pre, **kw)
        got_c = flash_decode.decode_attention(*dec, **dkw)
        torch.cuda.synchronize()
        if empty is not None and got_p[empty:].abs().max().item() != 0.0:
            raise AssertionError("pod: the empty run's tile is not zero")
        if not torch.isfinite(got_d).all() or got_d[0].abs().max().item() != 0.0:
            raise AssertionError("pod: the seqlen-0 slot is not zero")
        case_err = 0.0
        for lo, n in ranges:
            e, _ = check_attention(f"pod prefill rows {lo}..{lo + n}",
                                   got_p[lo:lo + n], ref_p[lo:lo + n],
                                   PREFILL_TOL)
            case_err = max(case_err, e)
        for b, n in enumerate(depths):
            if n:
                e, _ = check_attention(f"pod decode slot {b} at depth {n}",
                                       got_d[b:b + 1], ref_d[b:b + 1],
                                       DECODE_TOL)
                case_err = max(case_err, e)
        err = max(err, case_err)
        vs_b = (got_p.float() - got_b.float()).abs().max().item()
        vs_c = (got_d.float() - got_c.float()).abs().max().item()
        checks.append(f"{len(ranges)} run(s): max |F - plain| {case_err}, "
                      f"max |F - B| {vs_b}, max |F - C| {vs_c}")
    log("(a) pod_attention, prefill fused with B=8 decode slots at depths "
        f"{depths}: " + "; ".join(checks))
    f1 = (pre1[0], qd, cache, *pre1[2:5], trows_d, seqlens, layer)
    pairs = 512 * 3584 + 512 * 513 // 2   # causal (query, key) pairs of pre1
    b_ms, b_by = bound(
        (2 * 512 * HQ * D + 4096 * 2 * HKV * D
         + sum(depths) * 2 * HKV * D + 2 * 8 * HQ * D) * es + 8 * 4,
        4 * HQ * D * (pairs + sum(depths)))
    res = dict(
        name="pod_attention", route="cuda",
        source="vattention_tpu_torch/csrc/pod_attention.cu",
        replaces="vattention_tpu/ops/pod_fused.py:341",
        max_abs_err=err,
        ms=timer(lambda: pod_fused.pod_attention(*f1, **kw)),
        serial_ms=timer(lambda: (flash_prefill.prefill_attention(*pre1, **kw),
                                 flash_decode.decode_attention(*dec, **dkw))),
        plain_ms=timer(lambda: pod_fused.pod_attention_plain(*f1, **kw),
                       iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"chunk 512 at kv_len 4096 + B=8 depths {depths}, "
              f"Hq={HQ} Hkv={HKV} D={D} bf16")
    log(f"(a) pod_attention: {res['shape']}: ms {res['ms']:.4f}, B then C "
        f"serially {res['serial_ms']:.4f}, plain {res['plain_ms']:.4f}, "
        f"SDPA prefill + SDPA decode {sdpa_ms:.4f}, bound {b_ms:.4f} "
        f"({b_by})")
    # each role of F alone in F's grid (the other role's blocks have no
    # work: every slot idle, or every prefill run empty) beside the kernel
    # that runs that body alone
    idle = torch.zeros_like(seqlens)
    empty = torch.zeros_like(pre1[3])
    f_pre = (*f1[:7], idle, layer)
    f_dec = (*f1[:4], empty, *f1[5:])
    log("(a) pod_attention by role: prefill role alone (every slot idle) "
        f"{timer(lambda: pod_fused.pod_attention(*f_pre, **kw)):.4f} ms, "
        f"B {timer(lambda: flash_prefill.prefill_attention(*pre1, **kw)):.4f}"
        " ms; decode role alone (every run empty) "
        f"{timer(lambda: pod_fused.pod_attention(*f_dec, **kw)):.4f} ms, C "
        f"{timer(lambda: flash_decode.decode_attention(*dec, **dkw)):.4f} ms")
    return res


def ptxas_report(names=("prefill_attention", "paged_prefill_attention",
                        "decode_attention", "pod_attention")):
    """Registers, spills and shared memory per block of the bf16 prefill
    body's kernels (B, G, E and H, named by their q map and row map) and
    of the G = 8 instances of the others, from each library's ptxas log
    (written when the library is built) and the dynamic shared memory the
    launchers ask for; ptxas's notes on wgmma, if any, follow."""
    import ctypes

    from vattention_tpu_torch.ops.cuda_build import library, library_path

    pre = library("prefill_attention").vattn_prefill_smem_bytes
    pre.argtypes = [ctypes.c_int]
    for name in names:
        path = library_path(name).with_suffix(".so.log")
        if not path.exists():
            log(f"ptxas {name}.cu: no build log (built by an earlier run)")
            continue
        fn = None
        for line in path.read_text().splitlines():
            if "wgmma" in line:
                log(f"ptxas {name}.cu: {line.strip()}")
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spills = m.group(1), "spills not reported"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spills = f"{m.group(1)}/{m.group(2)} bytes spilled"
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and ("tc_kernel" in fn or "Li8E" in fn):
                bf16 = "bfloat16" in fn
                kernel = re.search(r"\d+([a-z_]+_kernel)", fn).group(1)
                maps = re.findall(r"RunTiles|OneRun|TileRows|BlockTables|"
                                  r"Segments", fn)
                if maps:
                    kernel += f"<{', '.join(maps)}>"
                smem = ""
                if name != "decode_attention" and bf16:
                    # F's bf16 blocks carve the prefill body's buffer,
                    # which is larger than C's
                    static = re.search(r"(\d+) bytes smem", line)
                    smem = (f", shared memory {pre(1)} B dynamic + "
                            f"{static.group(1) if static else 0} B static "
                            "per block")
                log(f"ptxas {name}.cu: {kernel} "
                    f"({'bf16' if bf16 else 'f32'}"
                    f"{'' if 'tc_kernel' in fn else ', G=8'}): "
                    f"{m.group(1)} registers, {spills}{smem}")


def paged_kernels(dev, cache, pool_rows, timer, randn, layer):
    """(a) for the paged engine: kernel E at blocks of 16 and 256 tokens
    over the first ``pool_rows`` rows of ``cache``, E against B on the
    same rows, and kernel C over 16-token blocks.  Returns E's result at
    256-token blocks (fa_paged_256, the engine of phase (d))."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention)
    from vattention_tpu_torch.ops.utils import cdiv

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    es = 2
    sm = D ** -0.5
    pad = 128
    poison = 2 ** 30
    rng = np.random.default_rng(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def tables_for(depths, bs):
        """Block tables of a seeded permutation of the pool, one row per
        depth, 8192 // bs wide, 2**30 past each row's last valid block."""
        perm = rng.permutation(pool_rows // bs)
        tables = np.full((len(depths), 8192 // bs), poison, np.int32)
        used = 0
        for r, n in enumerate(depths):
            k = cdiv(n, bs)
            tables[r, :k] = perm[used:used + k]
            used += k
        return torch.from_numpy(tables).to(dev)

    # K=4 runs (q_start, kv_len, chunk) and the empty run a tail tile maps to
    runs = [(3584, 4096, 512), (0, 128, 128), (2000, 2100, 100), (0, 60, 60)]
    qt_run, offs, off = [], [], 0
    for r, (_, _, chunk) in enumerate(runs):
        offs.append(off)
        qt_run += [(r, i) for i in range(cdiv(chunk, pad))]
        off += cdiv(chunk, pad) * pad
    qt_run.append((len(runs), 0))
    qt_run = torch.tensor(qt_run, dtype=torch.int32, device=dev)
    depths = [n for _, n, _ in runs] + [0]
    qinfo = torch.tensor([(q0, n) for q0, n, _ in runs] + [(0, 0)],
                         dtype=torch.int32, device=dev)
    q = randn(qt_run.shape[0] * pad, HQ, D)
    # the timed case: chunk 512 at kv_len 4096 alone, as kernel B's
    qt_run1 = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                           device=dev)
    qinfo1 = torch.tensor([[3584, 4096], [0, 0]], dtype=torch.int32,
                          device=dev)
    pos = torch.arange(4096, device=dev)
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    b_ms, b_by = bound((2 * 512 * HQ * D + 4096 * 2 * HKV * D) * es,
                       4 * HQ * D * int(mask.sum().item()))
    out = None
    for bs in (16, 256):
        tables = tables_for(depths, bs)
        args = (q, cache, qt_run, qinfo, tables, layer)
        kw = dict(block_size=bs, pad_tile=pad, sm_scale=sm)
        got = paged_attention.paged_prefill_attention(*args, **kw)
        ref = paged_attention.paged_prefill_attention_plain(*args, **kw)
        # kernel B on the same rows: the block table as a row table
        rows_b = paged_attention.paged_tile_rows(
            torch.where(tables == poison, 0, tables), qinfo[:, 1], bs)
        got_b = flash_prefill.prefill_attention(
            q, cache, qt_run, qinfo, rows_b, layer, sub=bs, pad_tile=pad,
            sm_scale=sm)
        torch.cuda.synchronize()
        if got[off:].abs().max().item() != 0.0:
            raise AssertionError(
                f"paged prefill bs {bs}: the empty run's tile is not zero")
        err, checks = 0.0, []
        for r, (q0, n, chunk) in enumerate(runs):
            e, rel = check_attention(
                f"paged prefill bs {bs}, run {r}",
                got[offs[r]:offs[r] + chunk], ref[offs[r]:offs[r] + chunk],
                PREFILL_TOL)
            checks.append(f"chunk {chunk} at kv_len {n}: {e} "
                          f"(row worst {rel:.5f})")
            err = max(err, e)
        vs_b = (got - got_b).abs().max().item()
        log(f"(a) paged_prefill_attention bs {bs}, tables poisoned past "
            f"each run's last block: " + "; ".join(checks)
            + f"; max |E - B| on the same rows {vs_b}")
        t1 = (q[:512], cache, qt_run1, qinfo1,
              tables_for([4096, 0], bs), layer)
        grow = paged_attention.block_rows(t1[4][0], 4096, bs)
        kg = cache[layer, 0][:, grow][None]
        vg = cache[layer, 1][:, grow][None]
        qg = q[:512].transpose(0, 1)[None]
        res = dict(
            name="paged_prefill_attention", route="cuda",
            source="vattention_tpu_torch/csrc/paged_prefill_attention.cu",
            replaces="vattention_tpu/ops/paged_attention.py:107",
            max_abs_err=err,
            ms=timer(lambda: paged_attention.paged_prefill_attention(
                *t1, **kw)),
            plain_ms=timer(
                lambda: paged_attention.paged_prefill_attention_plain(
                    *t1, **kw), iters=3),
            library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                          enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"chunk 512 at kv_len 4096 over {bs}-token blocks, "
                  f"Hq={HQ} Hkv={HKV} D={D} bf16")
        del kg, vg
        log(f"(a) paged_prefill_attention: {res['shape']}: ms "
            f"{res['ms']:.4f} plain {res['plain_ms']:.4f} library "
            f"{res['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
        out = res

    # kernel C over 16-token blocks: B=8 at depths 0..4096
    bs = 16
    seqlens_l = [0, 1, 17, 512, 1000, 2048, 3000, 4096]
    seqlens = torch.tensor(seqlens_l, dtype=torch.int32, device=dev)
    tables = tables_for(seqlens_l, bs)
    qd = randn(8, HQ, D)
    dargs = (qd, cache, tables, seqlens, layer)
    dkw = dict(block_size=bs, sm_scale=sm)
    got = paged_attention.paged_decode_attention(*dargs, **dkw)
    rows = paged_attention.paged_tile_rows(tables, seqlens, bs)
    cargs = (qd, cache, rows, seqlens, layer)
    ckw = dict(sub=bs, sm_scale=sm)
    ref = flash_decode.decode_attention_plain(*cargs, **ckw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
        raise AssertionError("paged decode: the seqlen-0 slot is not zero")
    err = 0.0
    for b, n in enumerate(seqlens_l):
        if n:
            e, _ = check_attention(f"paged decode slot {b} at depth {n}",
                                   got[b:b + 1], ref[b:b + 1], DECODE_TOL)
            err = max(err, e)
    kpad = torch.zeros((8, HKV, 4096, D), dtype=torch.bfloat16, device=dev)
    vpad = torch.zeros_like(kpad)
    for b, n in enumerate(seqlens_l):
        if n:
            r = paged_attention.block_rows(tables[b], n, bs)
            kpad[b, :, :n] = cache[layer, 0][:, r]
            vpad[b, :, :n] = cache[layer, 1][:, r]
    dmask = (torch.arange(4096, device=dev)[None, :]
             < seqlens[:, None])[:, None, None, :]
    c_bound, c_by = bound((sum(seqlens_l) * 2 * HKV * D + 2 * 8 * HQ * D)
                          * es + 8 * 4, 4 * HQ * D * sum(seqlens_l))
    ms = timer(lambda: flash_decode.decode_attention(*cargs, **ckw))
    plain_ms = timer(lambda: flash_decode.decode_attention_plain(
        *cargs, **ckw), iters=3)
    library_ms = timer(lambda: sdpa(qd[:, :, None], kpad, vpad,
                                    attn_mask=dmask, enable_gqa=True))
    log(f"(a) decode_attention over {bs}-token blocks (sub={bs}), B=8 "
        f"depths {seqlens_l}: max_abs_err {err} ms {ms:.4f} plain "
        f"{plain_ms:.4f} library {library_ms:.4f} bound {c_bound:.4f} "
        f"({c_by})")
    return out


def single_run_kernels(dev, cache, pool_rows, bt, sub, n_sub, timer, randn,
                       layer):
    """(a) for kernels G and H at kernel B's shape (chunk 512 at kv_len
    4096): G over 8 extents of 512 tokens starting at 2048-token block
    starts, held against its plain version and against B on the same rows;
    H over a seeded permutation of the pool's 16- and 256-token blocks, its
    table poisoned past the run's last block, held against its plain
    version and against E on one run.  Returns G's result and H's at
    256-token blocks."""
    from vattention_tpu_torch.ops import flash_prefill, paged_attention
    from vattention_tpu_torch.ops.utils import cdiv, tile_rows_from_segments

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    es = 2
    sm = D ** -0.5
    poison = 2 ** 30
    rng = np.random.default_rng(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(512, HQ, D)
    qinfo = torch.tensor([3584, 4096], dtype=torch.int32, device=dev)
    qt_run = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                          device=dev)
    pos = torch.arange(4096, device=dev)
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    b_ms, b_by = bound((2 * 512 * HQ * D + 4096 * 2 * HKV * D) * es,
                       4 * HQ * D * int(mask.sum().item()))
    qg = q.transpose(0, 1)[None]

    def timed(name, source, replaces, err, fn, plain, grow, shape):
        kg = cache[layer, 0][:, grow][None]
        vg = cache[layer, 1][:, grow][None]
        res = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=err, ms=timer(fn), plain_ms=timer(plain, iters=3),
            library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                          enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, shape=shape)
        log(f"(a) {name}: {shape}: ms {res['ms']:.4f} plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']:.4f} bound "
            f"{b_ms:.4f} ({b_by})")
        return res

    # -- G: 8 extents at block starts, in no order
    starts = [3, 9, 1, 14, 6, 11, 20, 17]
    seg_row = np.array([s * bt for s in starts], np.int32)
    seg_cum = np.arange(9, dtype=np.int32) * 512
    sr = torch.from_numpy(seg_row).to(dev)
    sc = torch.from_numpy(seg_cum).to(dev)
    gargs = (q, cache, sr, sc, qinfo, layer)
    got = flash_prefill.segment_prefill_attention(*gargs, sm_scale=sm)
    ref = flash_prefill.segment_prefill_attention_plain(*gargs, sm_scale=sm)
    rows_b = torch.from_numpy(tile_rows_from_segments(
        seg_row[None], seg_cum[None], sub, n_sub)).to(dev)
    got_b = flash_prefill.prefill_attention(
        q, cache, qt_run, qinfo[None], rows_b, layer, sub=sub, pad_tile=128,
        sm_scale=sm)
    torch.cuda.synchronize()
    err, rel = check_attention("segment prefill", got, ref, PREFILL_TOL)
    vs_b = (got.float() - got_b.float()).abs().max().item()
    log(f"(a) segment_prefill_attention, 8 extents of 512 tokens: max abs "
        f"err {err} (row worst {rel:.5f}); max |G - B| on the same rows "
        f"{vs_b}")
    if not torch.equal(got, got_b):
        raise AssertionError("G differs from B on the same rows")
    out = [timed(
        "segment_prefill_attention",
        "vattention_tpu_torch/csrc/prefill_attention.cu",
        "vattention_tpu/ops/flash_prefill.py:178", err,
        lambda: flash_prefill.segment_prefill_attention(*gargs, sm_scale=sm),
        lambda: flash_prefill.segment_prefill_attention_plain(
            *gargs, sm_scale=sm),
        flash_prefill.segment_rows(sr, sc, 4096),
        f"chunk 512 at kv_len 4096 over 8 extents, Hq={HQ} Hkv={HKV} "
        f"D={D} bf16")]

    # -- H: a permutation of the pool's blocks, the tail poisoned
    for bs in (16, 256):
        n = cdiv(4096, bs)
        table = np.full(8192 // bs, poison, np.int32)
        table[:n] = rng.permutation(pool_rows // bs)[:n]
        table = torch.from_numpy(table).to(dev)
        hargs = (q, cache, table, qinfo, layer)
        hkw = dict(block_size=bs, sm_scale=sm)
        got = paged_attention.paged_prefill_attention_single(*hargs, **hkw)
        ref = paged_attention.paged_prefill_attention_single_plain(*hargs,
                                                                   **hkw)
        got_e = paged_attention.paged_prefill_attention(
            q, cache, qt_run, qinfo[None], table[None], layer,
            block_size=bs, pad_tile=128, sm_scale=sm)
        torch.cuda.synchronize()
        err, rel = check_attention(f"paged prefill single bs {bs}", got, ref,
                                   PREFILL_TOL)
        vs_e = (got.float() - got_e.float()).abs().max().item()
        log(f"(a) paged_prefill_attention_single bs {bs}, table poisoned "
            f"past the run's last block: max abs err {err} (row worst "
            f"{rel:.5f}); max |H - E| on one run {vs_e}")
        if not torch.equal(got, got_e):
            raise AssertionError(f"H differs from E on one run (bs {bs})")
        res = timed(
            "paged_prefill_attention_single",
            "vattention_tpu_torch/csrc/paged_prefill_attention.cu",
            "vattention_tpu/ops/paged_attention.py:32", err,
            lambda: paged_attention.paged_prefill_attention_single(
                *hargs, **hkw),
            lambda: paged_attention.paged_prefill_attention_single_plain(
                *hargs, **hkw),
            paged_attention.block_rows(table, 4096, bs),
            f"chunk 512 at kv_len 4096 over {bs}-token blocks, Hq={HQ} "
            f"Hkv={HKV} D={D} bf16")
    return out + [res]


def long_context(dev, cache, pool_rows, bt, timer, randn, layer):
    """(a) the prefill body at the sweep's deepest prefill, chunk 2048 at
    kv_len 32768: G over 8 extents of 4096 tokens at 2048-token block
    starts, H over a seeded permutation of the pool's 16-token blocks with
    its tail poisoned; each held against its plain version (256 query
    tokens at a time) and timed beside one SDPA call on the same gathered
    K/V and beside its bound.  Logged only: the JSON line keeps (a)'s
    512@4096 shape."""
    from vattention_tpu_torch.ops import flash_prefill, paged_attention

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    es = 2
    sm = D ** -0.5
    n, chunk, bs = 32768, 2048, 16
    q = randn(chunk, HQ, D)
    qinfo = torch.tensor([n - chunk, n], dtype=torch.int32, device=dev)
    pos = torch.arange(n, device=dev)
    mask = (n - chunk + torch.arange(chunk, device=dev))[:, None] \
        >= pos[None, :]
    pairs = chunk * (n - chunk) + chunk * (chunk + 1) // 2
    b_ms, b_by = bound((2 * chunk * HQ * D + n * 2 * HKV * D) * es,
                       4 * HQ * D * pairs)
    qg = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    starts = [10, 2, 18, 6, 14, 0, 22, 8]      # pairs of 2048-token blocks
    sr = torch.tensor([s_ * bt for s_ in starts], dtype=torch.int32,
                      device=dev)
    sc = torch.arange(9, dtype=torch.int32, device=dev) * (n // 8)
    table = np.full(n // bs + 8, 2 ** 30, np.int32)
    table[:n // bs] = np.random.default_rng(3).permutation(
        pool_rows // bs)[:n // bs]
    table = torch.from_numpy(table).to(dev)
    cases = (
        ("segment_prefill_attention (G), 8 extents",
         lambda: flash_prefill.segment_prefill_attention(
             q, cache, sr, sc, qinfo, layer, sm_scale=sm),
         lambda: flash_prefill.segment_prefill_attention_plain(
             q, cache, sr, sc, qinfo, layer, sm_scale=sm),
         flash_prefill.segment_rows(sr, sc, n)),
        ("paged_prefill_attention_single (H), 16-token blocks",
         lambda: paged_attention.paged_prefill_attention_single(
             q, cache, table, qinfo, layer, block_size=bs, sm_scale=sm),
         lambda: paged_attention.paged_prefill_attention_single_plain(
             q, cache, table, qinfo, layer, block_size=bs, sm_scale=sm),
         paged_attention.block_rows(table, n, bs)))
    for what, fn, plain, grow in cases:
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check_attention(f"{what} at chunk {chunk}, kv_len {n}",
                                   got, ref, PREFILL_TOL)
        del got, ref
        kg = cache[layer, 0][:, grow][None]
        vg = cache[layer, 1][:, grow][None]
        ms = timer(fn)
        lib = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                 enable_gqa=True))
        del kg, vg
        log(f"(a) {what}: chunk {chunk} at kv_len {n}, Hq={HQ} Hkv={HKV} "
            f"D={D} bf16: max abs err {err} (row worst {rel:.5f}) ms "
            f"{ms:.4f} library {lib:.4f} (SDPA, gathered K/V) bound "
            f"{b_ms:.4f} ({b_by})")


def strict_relocation_plan(L, HKV, D, es, seed=0, blocks=14):
    """A relocation plan with chained moves from the allocator in strict
    contiguity (max_segments=1) on a seeded dynamic workload, plus the
    arena rows of every live slot's tokens before and after the plan."""
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator

    a = VAttentionAllocator()
    a.init_kvcache(num_layers=L, num_kv_heads=HKV, head_size=D,
                   max_batch_size=8, max_context_length=8192,
                   dtype_bytes=es, page_size=2 * 2**20, max_segments=1)
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
            prompt = int(rng.integers(10, 6000))
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
            a.seq_lens[sid] += 1
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


# --------------------------------------------------------------------- #
# dense references (plain PyTorch, float32)
# --------------------------------------------------------------------- #
def dense_logits(model, params, ids, dev):
    """Last-position logits of a full-recompute float32 forward."""
    from vattention_tpu_torch.model_executor.layers.activation import (
        silu_and_mul)
    from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
    from vattention_tpu_torch.ops.attention_ref import mha_reference

    a, D = model.arch, model.head_dim
    lp = params["layers"]
    T = len(ids)
    x = params["embed"][torch.tensor(ids, device=dev)].float()
    positions = torch.arange(T, device=dev)
    for l in range(a.num_layers):
        h = rms_norm(x, lp["input_norm"][l].float(), a.rms_norm_eps)
        qkv = h @ lp["qkv_w"][l].float()
        q = qkv[:, :model.hq * D].reshape(T, model.hq, D)
        k = qkv[:, model.hq * D:(model.hq + model.hkv) * D].reshape(
            T, model.hkv, D)
        v = qkv[:, (model.hq + model.hkv) * D:].reshape(T, model.hkv, D)
        q, k = model.rope(positions, q, k)
        attn = mha_reference(q, k, v, causal=True, sm_scale=model.sm_scale)
        x = x + attn.reshape(T, model.hq * D) @ lp["o_w"][l].float()
        h2 = rms_norm(x, lp["post_norm"][l].float(), a.rms_norm_eps)
        x = x + silu_and_mul(h2 @ lp["gate_up_w"][l].float()) \
            @ lp["down_w"][l].float()
    x = rms_norm(x, params["final_norm"].float(), a.rms_norm_eps)
    return x[-1] @ params["lm_head"].float()


def serve(engine, requests, stats=None):
    """requests: [(seq_id, prompt ids, max_tokens)] -> {seq_id: tokens};
    ``stats["steps"]`` gets the number of engine steps."""
    from vattention_tpu_torch import SamplingParams

    for seq_id, ids, max_tokens in requests:
        engine.add_request(prompt=None, prompt_token_ids=ids,
                           sampling_params=SamplingParams(
                               temperature=0.0, max_tokens=max_tokens,
                               ignore_eos=True),
                           seq_id=seq_id)
    out = {}
    steps = 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        if steps > 10_000:
            raise AssertionError("serving did not finish")
    if stats is not None:
        stats["steps"] = steps
    return out


def fresh_metrics():
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None


# --------------------------------------------------------------------- #
# (b) f32 parity
# --------------------------------------------------------------------- #
def parity_phase(dev, backend, tag):
    from vattention_tpu_torch import LLMEngine

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32", attention_backend=backend,
        scheduler_type="sarathi", max_model_len=512, max_batch_size=4,
        max_num_seqs=4, chunk_size=128, gpu_memory_utilization=0.9)
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([200, 37])}
    got = serve(engine, [(s, p, 6) for s, p in prompts.items()])
    runner = engine.worker.model_runner
    for seq_id, ids in prompts.items():
        ids = list(ids)
        for _ in range(6):
            ids.append(int(torch.argmax(dense_logits(
                runner.model, runner.params, ids, dev))))
        expect = ids[len(prompts[seq_id]):]
        if got[seq_id] != expect:
            raise AssertionError(
                f"({tag}) {seq_id}: engine {got[seq_id]} != dense {expect}")
        log(f"({tag}) f32 parity, {backend}, {seq_id}: engine == dense "
            f"{expect}")
    pod_steps = getattr(runner.backend, "pod_steps", None)
    if pod_steps is not None:
        log(f"({tag}) steps through kernel F: {pod_steps}")
        if pod_steps <= 0:
            raise AssertionError(f"({tag}) no step ran through kernel F")
    engine.cleanup()


# --------------------------------------------------------------------- #
# (c) full-width serving
# --------------------------------------------------------------------- #
def serving_phase(dev, kernels, backend, tag, required, idle,
                  reference=None):
    """Serve the 8 requests through a fresh full-width engine on
    ``backend``; the kernels named in ``required`` must launch in that run
    and those in ``idle`` must not.  Returns the launch counts and the
    tokens; with ``reference`` (another run's tokens) prints how many
    agree."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="yi-6b-200k", dtype="bfloat16", attention_backend=backend,
        scheduler_type="sarathi", chunk_size=512, max_model_len=8192,
        max_batch_size=8, max_num_seqs=8, seed=0)
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 4097, 8)
    requests = [(f"s{i}", rng.integers(1, 64000, int(n)).tolist(), 32)
                for i, n in enumerate(lens)]
    cache_engine = engine.worker.cache_engine

    # the main path: the 8 requests, with the launch counts read around it
    stats = {}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = serve(engine, requests, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in kernels}
    moves = getattr(cache_engine, "pending_moves", 0)
    n_gen = sum(len(v) for v in out.values())
    n_prompt = int(lens.sum())
    if len(out) != 8 or n_gen != 8 * 32:
        raise AssertionError(
            f"({tag}) served {len(out)} requests, {n_gen} tokens")
    log(f"({tag}) {backend}: served {len(out)} requests in {stats['steps']} "
        f"steps: prompt tokens {n_prompt} (lengths {lens.tolist()}), "
        f"generated tokens {n_gen}, wall {wall:.3f} s, "
        f"{n_gen / wall:.2f} generated tok/s, "
        f"{(n_prompt + n_gen) / wall:.2f} processed tok/s")
    log(f"({tag}) launches in the 8-request run: "
        + ", ".join(f"{s} {n}" for s, n in counts.items())
        + f"; the allocator planned {moves} block moves")
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"({tag}) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"({tag}) a kernel of another path launched: "
                             f"{counts}")
    # kernel D runs once per non-empty relocation plan.  A request here
    # spans at most 4 blocks of 2048 tokens (max_model_len 8192) and may
    # hold 8 extents, so the allocator grows it without a copy and D has
    # nothing to do; phase (a) holds D at this path's shapes.  The paged
    # pool never relocates.
    relocate = ARENA_RELOCATE.symbol
    if (counts[relocate] > 0) != (moves > 0):
        raise AssertionError(f"({tag}) {moves} block moves but {relocate} "
                             f"launched {counts[relocate]} times")
    if reference is not None:
        same = sum(a == b for s in out for a, b in zip(out[s], reference[s]))
        log(f"({tag}) {same} of {n_gen} generated tokens equal (c)'s")

    # 2 short prompts: first token against a dense f32 reference
    short = [(f"p{i}", rng.integers(1, 64000, n).tolist(), 1)
             for i, n in enumerate((64, 200))]
    first = serve(engine, short)

    runner = engine.worker.model_runner
    for seq_id, ids, _ in short:
        logits = dense_logits(runner.model, runner.params, ids, dev)
        tok = first[seq_id][0]
        gap = float(logits.max() - logits[tok])
        log(f"({tag}) {seq_id} ({len(ids)} tokens): engine token {tok}, "
            f"dense top {int(logits.argmax())}, logit gap {gap:.5f} "
            f"(tolerance {LOGIT_GAP_TOL})")
        if not gap <= LOGIT_GAP_TOL:
            raise AssertionError(f"({tag}) {seq_id}: logit gap {gap}")
    profile_serving(engine, rng, tag)
    engine.cleanup()
    return counts, out


def profile_serving(engine, rng, tag):
    """Where the serving time goes: 4 requests of 2048 prompt tokens and 16
    greedy tokens under torch.profiler; device time by kernel family and
    the device's busy share of the wall time (one stream, no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [(f"t{i}", rng.integers(1, 64000, 2048).tolist(), 16)
            for i in range(4)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(engine, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"(p {tag}) the profiler recorded no device time (wall "
            f"{wall * 1e3:.1f} ms)")
        return
    families = {"port kernels A-F": 0.0, "matmul": 0.0, "other": 0.0}
    port = {}
    for name, ms, count in kernels:
        if any(s in name for s in ("kv_append_kernel", "prefill_attention",
                                   "decode_partial", "decode_merge",
                                   "arena_relocate", "pod_attention")):
            families["port kernels A-F"] += ms
            short = re.search(r"(\w+_kernel)", name).group(1)
            ms0, n0 = port.get(short, (0.0, 0))
            port[short] = (ms0 + ms, n0 + count)
        elif any(s in name.lower() for s in ("gemm", "gemv", "xmma", "nvjet",
                                             "cutlass", "matmul")):
            families["matmul"] += ms
        else:
            families["other"] += ms
    log(f"(p {tag}) profiled 4 x (2048 + 16) tokens: wall "
        f"{wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), "
        f"idle {100 - 100 * busy / (wall * 1e3):.1f}%; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in families.items()))
    log(f"(p {tag}) port kernels: " + ", ".join(
        f"{k} {ms:.2f} ms in {n}" for k, (ms, n) in sorted(
            port.items(), key=lambda kv: -kv[1][0])))
    for name, ms, count in sorted(kernels, key=lambda r: -r[1])[:8]:
        log(f"(p {tag})   {ms:9.2f} ms {count:6d} x {name[:90]}")


# --------------------------------------------------------------------- #
# (f) the kernel-level A/B entry points
# --------------------------------------------------------------------- #
def harness_phase(kernels):
    """Run the four harnesses at Yi-6B's attention geometry (their
    defaults) on the card; ``kernels`` (G, H) have their launch counts
    zeroed just before and read just after.  The sweep and the probe run
    with ``--check``: each G, H and C output they make is held against its
    plain version on the same inputs.  Raises when a kernel disagrees with
    its plain version or with a kernel it should equal."""
    from vattention_tpu_torch.microbenchmarks import (bench_pagesize,
                                                      bench_pod,
                                                      kernel_sweep,
                                                      probe_pod_depth)

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for bs in ("256", "16"):
        log(f"(f) kernel_sweep --block-size {bs}")
        kernel_sweep.main(["--block-size", bs, "--check"])
        gc.collect()
        torch.cuda.empty_cache()
    log("(f) bench_pagesize")
    bench_pagesize.main([])
    log("(f) bench_pod")
    bench_pod.main([])
    probes = [["--depth", str(d), "--check"]
              for d in (16384, 32768, 65536, 131072)]
    probes.append(["--depth", "16384", "--n-prefill", "3", "--check"])
    for argv in probes:
        log(f"(f) probe_pod_depth {' '.join(argv)}")
        if probe_pod_depth.main(argv) != 0:
            raise AssertionError(f"(f) probe_pod_depth {argv}: F differs "
                                 "from G then C")
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    log(f"(f) harnesses ran in {time.perf_counter() - t0:.1f} s; launches: "
        + ", ".join(f"{s} {n}" for s, n in counts.items()))
    if any(n <= 0 for n in counts.values()):
        raise AssertionError(f"(f) a kernel never launched: {counts}")
    return counts


# --------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from vattention_tpu_torch.ops import cuda_build
        from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE
        from vattention_tpu_torch.ops.cache_append import KV_APPEND
        from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
        from vattention_tpu_torch.ops.flash_prefill import (
            PREFILL_ATTENTION, SEGMENT_PREFILL_ATTENTION)
        from vattention_tpu_torch.ops.paged_attention import (
            PAGED_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE)
        from vattention_tpu_torch.ops.pod_fused import POD_ATTENTION
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    secs = cuda_build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {', '.join(f'{k} {v:.1f}' for k, v in secs.items())})")
    ptxas_report()

    single = [SEGMENT_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE]
    kernels = [KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION, ARENA_RELOCATE,
               PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single]
    results = kernel_phase(dev)
    parity_phase(dev, "fa_vattn", "b")
    parity_phase(dev, "fa_paged_16", "b'")
    parity_phase(dev, "fa_pod", "b''")
    counts_c, tokens_c = serving_phase(
        dev, kernels, "fa_vattn_2mb", "c",
        required=[KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION],
        idle=[PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single])
    # free the (c) engine's memory before the paged engine sizes its pool
    gc.collect()
    torch.cuda.empty_cache()
    counts_d, _ = serving_phase(
        dev, kernels, "fa_paged_256", "d",
        required=[KV_APPEND, PAGED_PREFILL_ATTENTION, DECODE_ATTENTION],
        idle=[PREFILL_ATTENTION, ARENA_RELOCATE, POD_ATTENTION, *single],
        reference=tokens_c)
    gc.collect()
    torch.cuda.empty_cache()
    counts_e, _ = serving_phase(
        dev, kernels, "fa_pod", "e",
        required=[POD_ATTENTION, KV_APPEND, PREFILL_ATTENTION,
                  DECODE_ATTENTION],
        idle=[PAGED_PREFILL_ATTENTION, ARENA_RELOCATE, *single],
        reference=tokens_c)
    f, b, c = (POD_ATTENTION.symbol, PREFILL_ATTENTION.symbol,
               DECODE_ATTENTION.symbol)
    log(f"(e) F + B = {counts_e[f]} + {counts_e[b]} against B in (c) "
        f"{counts_c[b]}; F + C = {counts_e[f]} + {counts_e[c]} against C in "
        f"(c) {counts_c[c]}")
    if (counts_e[f] + counts_e[b] != counts_c[b]
            or counts_e[f] + counts_e[c] != counts_c[c]):
        raise AssertionError("(e) the fused launches do not add up to (c)'s")
    gc.collect()
    torch.cuda.empty_cache()
    counts_f = harness_phase(single)

    # launches: E's from the paged run (d), F's from the POD run (e), G's
    # and H's from the harnesses (f), A-D's from the vattn run (c)
    launches = {
        "kv_append": (KV_APPEND, counts_c),
        "prefill_attention": (PREFILL_ATTENTION, counts_c),
        "decode_attention": (DECODE_ATTENTION, counts_c),
        "arena_relocate": (ARENA_RELOCATE, counts_c),
        "paged_prefill_attention": (PAGED_PREFILL_ATTENTION, counts_d),
        "pod_attention": (POD_ATTENTION, counts_e),
        "segment_prefill_attention": (SEGMENT_PREFILL_ATTENTION, counts_f),
        "paged_prefill_attention_single": (PAGED_PREFILL_SINGLE, counts_f)}
    for r in results:
        k, counts = launches[r["name"]]
        r["launches"] = counts[k.symbol]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, "
        "the kernels' build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
