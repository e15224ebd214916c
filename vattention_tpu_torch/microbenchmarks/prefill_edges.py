"""Edge cases of the shared prefill body (kernels B, E, F, G, H) on the
card, held against the plain versions and against each other.

One multi-run launch holds runs whose (q_start, kv_len) reach the body's
tile logic: kv_len 1, 63, 64, 65, 127, 128, 129, 200 and 257 (about the
bf16 body's 128-key tile edges over a bf16 arena and its 64-key ones over
a 1-byte arena); a
depth past 4096 that is no multiple of 64; q_start 40, 56 and 60 mod 64,
and 104, 120 and 124 mod 128, where a key tile lies wholly above one
warpgroup's rows (it skips the tile) or above some rows of a warpgroup
that still runs it (all their keys there are masked); and the empty run
(kv_len 0) that fixed-width padding maps a tail tile to.  With a sliding
``window`` every kernel takes it, and two more runs, q_start
``window + 40`` at kv_len ``window + 300`` and ``window + 100`` at
``window + 420``, put the window's edge inside a chunk, the second past
the middle of a 128-key tile; every row of the other runs past
``window`` then has its first key at ``q - window + 1``, which falls on,
before and after key tile edges across the runs' q_starts.

- B runs twice: over E's rows (block tables of 16-token blocks drawn as a
  seeded permutation of the pool, every entry past a run's last valid
  block set to 2**30) and over G's rows (per run up to 4 extents cut at
  unaligned positions, so extents split key tiles); each is held
  against its plain version with ``check_attention``.
- E must equal B on E's rows, F's prefill output B on E's rows, and F's
  decode output C on the same slots, bit for bit.
- Each run alone: G must equal B on G's rows and H must equal E, bit for
  bit.

``check_prefill_edges`` raises on the first failure.
"""

from __future__ import annotations

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.timing import check_attention
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import (
    prefill_attention, prefill_attention_plain, segment_prefill_attention)
from vattention_tpu_torch.ops.paged_attention import (
    paged_prefill_attention, paged_prefill_attention_single, paged_tile_rows)
from vattention_tpu_torch.ops.pod_fused import pod_attention
from vattention_tpu_torch.ops.utils import cdiv, tile_rows_from_segments

# (q_start, kv_len) of each run (its chunk: kv_len - q_start tokens), then
# the empty run
EDGE_RUNS = [(0, 1), (0, 63), (0, 64), (1, 65), (0, 200), (3900, 4133),
             (40, 170), (56, 300), (60, 190), (0, 127), (0, 128), (1, 129),
             (0, 257), (104, 330), (248, 400), (124, 260), (0, 0)]
BLOCK = 16          # E's and H's block size, C's sub for F's decode slots
POISON = 2 ** 30
PAD = 128           # pad_tile: the scheduler's q charge unit
DECODE_DEPTHS = [0, 17, 1000]


def _extents(rng, kv_len: int, rows: int):
    """Up to 4 extents covering [0, kv_len), cut at unaligned positions,
    each at a random row below ``rows``: (seg_row [8], seg_cum [9])."""
    cuts = sorted(set(rng.integers(1, kv_len, 3).tolist())) if kv_len > 1 \
        else []
    bounds = [0] + cuts + [kv_len]
    seg_row = np.zeros(8, np.int32)
    seg_cum = np.full(9, kv_len, np.int32)
    for j in range(len(bounds) - 1):
        seg_row[j] = rng.integers(0, rows - (bounds[j + 1] - bounds[j]))
        seg_cum[j] = bounds[j]
    return seg_row, seg_cum


def _tables(rng_perm, depths, width: int) -> np.ndarray:
    """Block tables taking consecutive blocks of ``rng_perm`` for each
    depth, POISON past each row's last valid block."""
    tables = np.full((len(depths), width), POISON, np.int32)
    used = 0
    for r, n in enumerate(depths):
        k = cdiv(n, BLOCK)
        tables[r, :k] = rng_perm[used:used + k]
        used += k
    return tables


def edge_runs(window=None):
    """(q_start, kv_len) of each run, the empty run last."""
    extra = ([(window + 40, window + 300), (window + 100, window + 420)]
             if window else [])
    return EDGE_RUNS[:-1] + extra + EDGE_RUNS[-1:]


def check_prefill_edges(cache: torch.Tensor, hq: int, layer: int,
                        seed: int = 0, sm_scale: float | None = None,
                        out_scale: float = 1.0, window=None):
    """The cases above over ``cache`` ([L, 2, Hkv, R, D] on the card, R >=
    8192, or 8192 + 2 * ``window`` + 720 under a window; a 1-byte arena is read
    by bf16 queries; an int8 arena's step goes in ``sm_scale`` and
    ``out_scale``) with ``hq`` query heads drawn from ``seed``, every
    kernel under ``window`` (None: none).  Raises on the first failure;
    returns (max abs err against the plain versions, the worst row's err
    as a fraction of its largest output)."""
    dev = cache.device
    runs = edge_runs(window)
    R, D = cache.shape[3], cache.shape[4]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sm = D ** -0.5 if sm_scale is None else sm_scale
    qdt = torch.bfloat16 if cache.element_size() == 1 else cache.dtype
    K = len(runs)
    chunks = [n - q0 for q0, n in runs]
    pads = [cdiv(max(c, 1), PAD) * PAD for c in chunks]
    offs = np.cumsum([0] + pads[:-1]).tolist()
    qt_run = torch.tensor([(r, i) for r in range(K)
                           for i in range(pads[r] // PAD)],
                          dtype=torch.int32, device=dev)
    qinfo = torch.tensor(runs, dtype=torch.int32, device=dev)
    q = torch.randn((sum(pads), hq, D), generator=gen, device=dev).to(qdt)
    qd = torch.randn((len(DECODE_DEPTHS), hq, D), generator=gen,
                     device=dev).to(qdt)

    depths = [n for _, n in runs]
    width = cdiv(max(depths), BLOCK) + 2
    perm = rng.permutation(R // BLOCK)
    tables = torch.from_numpy(_tables(perm, depths, width)).to(dev)
    rows_e = paged_tile_rows(torch.where(tables == POISON, 0, tables),
                             qinfo[:, 1], BLOCK)
    dec_tables = torch.from_numpy(
        _tables(perm[::-1], DECODE_DEPTHS, width)).to(dev)
    seqlens = torch.tensor(DECODE_DEPTHS, dtype=torch.int32, device=dev)
    dec_rows = paged_tile_rows(torch.where(dec_tables == POISON, 0,
                                           dec_tables), seqlens, BLOCK)
    segs = [_extents(rng, n, R) if n else
            (np.zeros(8, np.int32), np.zeros(9, np.int32)) for n in depths]
    seg_row = np.stack([s for s, _ in segs])
    seg_cum = np.stack([c for _, c in segs])
    rows_g = torch.from_numpy(tile_rows_from_segments(
        seg_row, seg_cum, 1, width * BLOCK)).to(dev)

    kw = dict(pad_tile=PAD, sm_scale=sm, window=window)
    b_e = prefill_attention(q, cache, qt_run, qinfo, rows_e, layer,
                            sub=BLOCK, **kw)
    b_g = prefill_attention(q, cache, qt_run, qinfo, rows_g, layer, sub=1,
                            **kw)
    e = paged_prefill_attention(q, cache, qt_run, qinfo, tables, layer,
                                block_size=BLOCK, **kw)
    f_p, f_d = pod_attention(q, qd, cache, qt_run, qinfo, rows_e, dec_rows,
                             seqlens, layer, sub=BLOCK, **kw)
    c = decode_attention(qd, cache, dec_rows, seqlens, layer, sub=BLOCK,
                         sm_scale=sm, window=window)
    ref_e = prefill_attention_plain(q, cache, qt_run, qinfo, rows_e, layer,
                                    sub=BLOCK, **kw)
    ref_g = prefill_attention_plain(q, cache, qt_run, qinfo, rows_g, layer,
                                    sub=1, **kw)
    torch.cuda.synchronize()

    err, rel = 0.0, 0.0
    for r, (q0, n) in enumerate(runs):
        if n == 0:
            if b_e[offs[r]:offs[r] + pads[r]].abs().max().item() != 0.0:
                raise AssertionError("edge cases: the empty run's tile is "
                                     "not zero")
            continue
        sl = slice(offs[r], offs[r] + chunks[r])
        for what, got, ref in (("E's rows", b_e, ref_e),
                               ("G's rows", b_g, ref_g)):
            e_, r_ = check_attention(
                f"edge case q_start {q0} kv_len {n}, B on {what}", got[sl],
                ref[sl], scale=out_scale)
            err, rel = max(err, e_), max(rel, r_)
    for what, a, b in (("E", e, b_e), ("F's prefill", f_p, b_e),
                       ("F's decode", f_d, c)):
        if not torch.equal(a, b):
            raise AssertionError(f"edge cases: {what} differs from "
                                 f"{'C' if 'decode' in what else 'B'} on "
                                 "the same rows")
    for r, (q0, n) in enumerate(runs):
        if n == 0:
            continue
        sl = slice(offs[r], offs[r] + pads[r])
        info = qinfo[r].clone()   # a row of its own: 16-byte aligned
        g = segment_prefill_attention(
            q[sl], cache, torch.from_numpy(seg_row[r]).to(dev),
            torch.from_numpy(seg_cum[r]).to(dev), info, layer, sm_scale=sm,
            window=window)
        h = paged_prefill_attention_single(q[sl], cache, tables[r].clone(),
                                           info, layer, block_size=BLOCK,
                                           sm_scale=sm, window=window)
        torch.cuda.synchronize()
        if not torch.equal(g, b_g[sl]):
            raise AssertionError(f"edge case q_start {q0} kv_len {n}: G "
                                 "differs from B on the same rows")
        if not torch.equal(h, e[sl]):
            raise AssertionError(f"edge case q_start {q0} kv_len {n}: H "
                                 "differs from E")
    return err, rel
