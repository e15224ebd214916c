"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a); on a machine
without one they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -p no:xdist -q

Kernels E and H (paged prefill) and C over block tables read tables
poisoned past each run's or slot's last valid block.  Kernels F (POD), G
(single-run arena prefill) and H share B's, C's or E's bodies, so their
outputs must equal those kernels' on the same rows bit for bit.
Tolerances: kv_append and arena_relocate move bytes and must match
exactly; the attention kernels sum in another order than the plain
versions' full softmax, so float32 is held to 1e-4 and bfloat16 outputs
(rounded once) to 2e-2.  The bf16 prefill body's edge cases
(``microbenchmarks/prefill_edges.py``) are held with
``timing.check_attention``: 2e-2 and each output row within 2^-6 of its
largest output.
"""

import numpy as np
import pytest
import torch

from vattention_tpu_torch.microbenchmarks.prefill_edges import (
    check_prefill_edges)
from vattention_tpu_torch.ops.arena_copy import (arena_relocate,
                                                 arena_relocate_plain)
from vattention_tpu_torch.ops.cache_append import kv_append, kv_append_plain
from vattention_tpu_torch.ops.flash_decode import (decode_attention,
                                                   decode_attention_plain)
from vattention_tpu_torch.ops.flash_prefill import (
    prefill_attention, prefill_attention_plain, segment_prefill_attention,
    segment_prefill_attention_plain)
from vattention_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_prefill_attention,
    paged_prefill_attention_plain, paged_prefill_attention_single,
    paged_prefill_attention_single_plain)
from vattention_tpu_torch.ops.pod_fused import (pod_attention,
                                                pod_attention_plain)
from vattention_tpu_torch.ops.utils import tile_rows_from_segments

pytestmark = pytest.mark.cuda

L, HKV, HQ, D = 2, 2, 8, 128
R = 4096
SUB = 256
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cache(rng, dtype, device):
    return torch.from_numpy(
        rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    ).to(device=device, dtype=dtype)


def _tables(extents_per_seq, n_sub):
    S = 8
    seg_row = np.zeros((len(extents_per_seq), S), np.int32)
    seg_cum = np.zeros((len(extents_per_seq), S + 1), np.int32)
    for b, extents in enumerate(extents_per_seq):
        t = 0
        for j, (row, n) in enumerate(extents):
            seg_row[b, j] = row
            seg_cum[b, j] = t
            t += n
        seg_cum[b, len(extents):] = t
    return tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_append_matches_plain(dev, dtype):
    rng = np.random.default_rng(0)
    cache = _cache(rng, dtype, dev)
    T = 40
    k = torch.from_numpy(rng.standard_normal((T, HKV, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((T, HKV, D)).astype(np.float32))
    rows = rng.permutation(R)[:T].astype(np.int32)
    rows[::7] = -1
    rows = torch.from_numpy(rows)
    expect = cache.cpu()
    kv_append_plain(expect, k.to(dtype), v.to(dtype), rows, 1)
    kv_append(cache, k.to(dev, dtype), v.to(dev, dtype), rows.to(dev), 1)
    torch.cuda.synchronize()
    assert torch.equal(cache.cpu(), expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_relocate_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    cache = _cache(rng, dtype, dev)
    bt = 256
    # chained: block 3 moves out before block 1 moves into its place
    src = torch.tensor([3, 1, 7, 0], dtype=torch.int32)
    dst = torch.tensor([5, 3, 1, 7], dtype=torch.int32)
    expect = cache.cpu()
    arena_relocate_plain(expect, src, dst, 4, bt)
    arena_relocate(cache, src.to(dev), dst.to(dev), 4, bt)
    torch.cuda.synchronize()
    assert torch.equal(cache.cpu(), expect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(dev, dtype):
    rng = np.random.default_rng(2)
    cache = _cache(rng, dtype, dev)
    extents = [[(0, 512)], [(512, 256), (1280, 768)], [(2048, 256)],
               [(3072, 512)]]
    seqlens = torch.tensor([500, 1000, 3, 0], dtype=torch.int32)
    tile_rows = torch.from_numpy(_tables(extents, R // SUB))
    q = torch.from_numpy(
        rng.standard_normal((4, HQ, D)).astype(np.float32)).to(dtype)
    expect = decode_attention_plain(q, cache.cpu(), tile_rows, seqlens, 1,
                                    sub=SUB, sm_scale=D ** -0.5)
    got = decode_attention(q.to(dev), cache, tile_rows.to(dev),
                           seqlens.to(dev), 1, sub=SUB, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_attention_matches_plain(dev, dtype):
    rng = np.random.default_rng(3)
    cache = _cache(rng, dtype, dev)
    pad = 128
    # run 0: chunk 200 at q_start 300 over two extents; run 1: chunk 60 at
    # 0; tail tiles map to the empty run 2
    extents = [[(256, 256), (1024, 512)], [(2048, 256)], []]
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    tile_rows = torch.from_numpy(_tables(extents, R // SUB))
    q = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    expect = prefill_attention_plain(q, cache.cpu(), qt_run, qinfo,
                                     tile_rows, 0, sub=SUB, pad_tile=pad,
                                     sm_scale=D ** -0.5)
    got = prefill_attention(q.to(dev), cache, qt_run.to(dev), qinfo.to(dev),
                            tile_rows.to(dev), 0, sub=SUB, pad_tile=pad,
                            sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.equal(got[3 * pad:], torch.zeros_like(got[3 * pad:]))
    tol = TOL[dtype]
    # rows past a run's chunk are padding: compare the real ones
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        torch.testing.assert_close(got[lo:hi].float(),
                                   expect[lo:hi].float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("bs", [16, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_attention_matches_plain(dev, dtype, bs):
    """Kernel E over permuted blocks, tables poisoned past each run's last
    valid block (2**30: a read there faults), one 64-key tile spanning
    four 16-token blocks."""
    rng = np.random.default_rng(4)
    cache = _cache(rng, dtype, dev)
    pad = 128
    perm = torch.from_numpy(rng.permutation(R // bs).astype(np.int32))
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    n0, n1 = -(-500 // bs), -(-60 // bs)
    tables = torch.full((3, n0 + 2), 2 ** 30, dtype=torch.int32)
    tables[0, :n0] = perm[:n0]
    tables[1, :n1] = perm[n0:n0 + n1]
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    q = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    kw = dict(block_size=bs, pad_tile=pad, sm_scale=D ** -0.5)
    expect = paged_prefill_attention_plain(q, cache.cpu(), qt_run, qinfo,
                                           tables, 1, **kw)
    got = paged_prefill_attention(q.to(dev), cache, qt_run.to(dev),
                                  qinfo.to(dev), tables.to(dev), 1, **kw)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.equal(got[3 * pad:], torch.zeros_like(got[3 * pad:]))
    tol = TOL[dtype]
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        torch.testing.assert_close(got[lo:hi].float(),
                                   expect[lo:hi].float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_matches_plain(dev, dtype):
    """Kernel C at sub = 16 over clamped block rows, poisoned tails."""
    rng = np.random.default_rng(5)
    cache = _cache(rng, dtype, dev)
    bs = 16
    seqlens = torch.tensor([0, 1, 17, 1000], dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(R // bs).astype(np.int32))
    tables = torch.full((4, 64), 2 ** 30, dtype=torch.int32)
    tables[0, 0] = 0
    used = 0
    for b, n in enumerate(seqlens.tolist()):
        k = -(-n // bs)
        tables[b, :k] = perm[used:used + k]
        used += k
    q = torch.from_numpy(
        rng.standard_normal((4, HQ, D)).astype(np.float32)).to(dtype)
    kw = dict(block_size=bs, sm_scale=D ** -0.5)
    expect = paged_decode_attention(q, cache.cpu(), tables, seqlens, 1, **kw)
    got = paged_decode_attention(q.to(dev), cache, tables.to(dev),
                                 seqlens.to(dev), 1, **kw)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pod_attention_matches_plain_and_b_then_c(dev, dtype):
    """Kernel F on two prefill runs, the empty run's tail tile and 4 slots
    (one idle, one deeper than a split): within tolerance of its plain
    version, and equal to kernels B and C on the same inputs.  Launched
    three times: each launch must leave its ticket counters at 0."""
    rng = np.random.default_rng(6)
    cache = _cache(rng, dtype, dev)
    pad = 128
    extents = [[(256, 256), (1024, 512)], [(2048, 256)], []]
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    pre_rows = torch.from_numpy(_tables(extents, R // SUB))
    dec_extents = [[(0, 512)], [(512, 256), (1280, 768)], [(2048, 256)],
                   [(3072, 512)]]
    seqlens = torch.tensor([500, 1000, 0, 3], dtype=torch.int32)
    dec_rows = torch.from_numpy(_tables(dec_extents, R // SUB))
    qp = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    qd = torch.from_numpy(
        rng.standard_normal((4, HQ, D)).astype(np.float32)).to(dtype)
    kw = dict(sub=SUB, pad_tile=pad, sm_scale=D ** -0.5)
    exp_p, exp_d = pod_attention_plain(qp, qd, cache.cpu(), qt_run, qinfo,
                                       pre_rows, dec_rows, seqlens, 1, **kw)
    args = (qp.to(dev), qd.to(dev), cache, qt_run.to(dev), qinfo.to(dev),
            pre_rows.to(dev), dec_rows.to(dev), seqlens.to(dev), 1)
    runs = [pod_attention(*args, **kw) for _ in range(3)]
    b = prefill_attention(args[0], cache, args[3], args[4], args[5], 1,
                          **kw)
    c = decode_attention(args[1], cache, args[6], args[7], 1, sub=SUB,
                         sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    for got_p, got_d in runs:
        assert torch.equal(got_p, b) and torch.equal(got_d, c)
    got_p, got_d = (x.cpu() for x in runs[0])
    assert torch.equal(got_p[3 * pad:], torch.zeros_like(got_p[3 * pad:]))
    assert torch.equal(got_d[2], torch.zeros_like(got_d[2]))
    tol = TOL[dtype]
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        torch.testing.assert_close(got_p[lo:hi].float(),
                                   exp_p[lo:hi].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_d.float(), exp_d.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_prefill_attention_matches_plain_and_b(dev, dtype, aligned):
    """Kernel G over 4 extents (aligned to SUB, or not aligned to any
    tile), within tolerance of its plain version and equal to kernel B on
    the same rows (B's table at SUB rows per entry, or at 1)."""
    rng = np.random.default_rng(7)
    cache = _cache(rng, dtype, dev)
    extents = ([(2048, 256), (512, 512), (3584, 256), (0, 256)] if aligned
               else [(2051, 300), (517, 77), (3601, 200), (5, 400)])
    sub = SUB if aligned else 1
    seg_row = np.zeros(8, np.int32)
    seg_cum = np.zeros(9, np.int32)
    for j, (row, n) in enumerate(extents):
        seg_row[j], seg_cum[j + 1] = row, seg_cum[j] + n
    seg_cum[len(extents) + 1:] = seg_cum[len(extents)]
    kv_len = int(seg_cum[-1])
    qinfo = torch.tensor([kv_len - 200, kv_len], dtype=torch.int32)
    q = torch.from_numpy(
        rng.standard_normal((256, HQ, D)).astype(np.float32)).to(dtype)
    sr, sc = torch.from_numpy(seg_row), torch.from_numpy(seg_cum)
    expect = segment_prefill_attention_plain(q, cache.cpu(), sr, sc, qinfo,
                                             1, sm_scale=D ** -0.5)
    got = segment_prefill_attention(q.to(dev), cache, sr.to(dev), sc.to(dev),
                                    qinfo.to(dev), 1, sm_scale=D ** -0.5)
    rows = torch.from_numpy(tile_rows_from_segments(
        seg_row[None], seg_cum[None], sub, -(-kv_len // sub))).to(dev)
    qt_run = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32, device=dev)
    got_b = prefill_attention(q.to(dev), cache, qt_run, qinfo.to(dev)[None],
                              rows, 1, sub=sub, pad_tile=128,
                              sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, got_b)
    tol = TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("bs", [16, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_single_matches_plain_and_e(dev, dtype, bs):
    """Kernel H over permuted blocks, the table poisoned past the run's
    last valid block, within tolerance of its plain version and equal to
    kernel E on one run; kv_len 0 gives zeros."""
    rng = np.random.default_rng(8)
    cache = _cache(rng, dtype, dev)
    n = -(-500 // bs)
    table = torch.full((n + 2,), 2 ** 30, dtype=torch.int32)
    table[:n] = torch.from_numpy(rng.permutation(R // bs)[:n].astype(np.int32))
    q = torch.from_numpy(
        rng.standard_normal((256, HQ, D)).astype(np.float32)).to(dtype)
    kw = dict(block_size=bs, sm_scale=D ** -0.5)
    qinfo = torch.tensor([300, 500], dtype=torch.int32)
    expect = paged_prefill_attention_single_plain(q, cache.cpu(), table,
                                                  qinfo, 1, **kw)
    qd, td, qi = q.to(dev), table.to(dev), qinfo.to(dev)
    got = paged_prefill_attention_single(qd, cache, td, qi, 1, **kw)
    qt_run = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32, device=dev)
    got_e = paged_prefill_attention(qd, cache, qt_run, qi[None], td[None], 1,
                                    pad_tile=128, **kw)
    empty = paged_prefill_attention_single(
        qd, cache, td, torch.zeros(2, dtype=torch.int32, device=dev), 1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, got_e)
    assert not empty.float().any()
    tol = TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("hq", [8, 16])
def test_prefill_body_edge_cases(dev, hq):
    """The bf16 prefill body at G = 4 and 8 (32- and 16-token q tiles):
    kv_len 1, 63, 64, 65, 200 and 4133, q_start 40, 56 and 60 mod 64 (a
    key tile above a whole warpgroup, or above some of its rows) and the
    empty run in one multi-run launch; B against its plain version over
    16-token block tables with poisoned tails and over unaligned extents,
    and E = B, F = B and C, G = B, H = E bit for bit."""
    rng = np.random.default_rng(9)
    cache = torch.from_numpy(
        rng.standard_normal((1, 2, HKV, 8192, D)).astype(np.float32)
    ).to(device=dev, dtype=torch.bfloat16)
    check_prefill_edges(cache, hq, 0)
