"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a); on a machine
without one they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -p no:xdist -q

Kernels E and H (paged prefill) and C over block tables read tables
poisoned past each run's or slot's last valid block.  Kernel C runs at
every group size, at 16- and 256-row table entries, at depths on its
tile and split edges, with idle slots (exactly zero), an all-idle batch
and a slot at 32K, and once under CUDA graph capture (its wrapper reads
nothing back from the device).  Kernels F (POD), G
(single-run arena prefill) and H share B's, C's or E's bodies, so their
outputs must equal those kernels' on the same rows bit for bit.
Tolerances: kv_append and arena_relocate move bytes and must match
exactly; the attention kernels sum in another order than the plain
versions' full softmax, so float32 is held to 1e-4 and bfloat16 outputs
(rounded once) to 2e-2.  The bf16 prefill body's edge cases
(``microbenchmarks/prefill_edges.py``) are held with
``timing.check_attention``: 2e-2 and each output row within 2^-6 of its
largest output.

1-byte arenas (e4m3, int8 in steps of 0.04): kernel A's quantization
equals its plain version's byte for byte (flush cutoff, saturation past
448, int8 half steps); every body widens every e4m3 pattern and int8 value
exactly (zero queries give one key of weight 1, so each output row is its
V row widened); C (every group, 16- and 256-row entries), B, E, G, H and F
on 1-byte arenas are held against their plain versions as above, with
G = B, H = E and F = B then C bit for bit; D moves 1-byte rows.  An int8
arena's scores take sm_scale * 0.04, as the backends fold its step.

Falcon-7B's attention geometry (71 query heads on 1 kv head, head dim 64
in the arena's 128 lanes): B, C, E, F, G and H on arenas of the model's
dtype, e4m3 and int8 against their plain versions, with G = B, H = E and
F = B then C bit for bit; C at G = 71 joins every decode case above, and
the prefill body's edge cases run at G = 71; a tiny falcon's captured
steps replay equal to the eager steps.

Kernel A with the rotation (``rope_kv_append``): every rope variant
(plain, linear by 4 and by 3, dynamic NTK, YaRN), float32 and bfloat16
models, arenas of the model's dtype, e4m3 and int8, head_dim 128 and 64
(zeros past 64), positions to 200K and rows of -1, bit for bit against
its plain version on the card; captured in a CUDA graph and replayed at
new positions and rows.

The captured serving step: a prompt's, a mixed and a decode step of tiny
models (llama, mistral, head_dim 64) on fa_vattn, fa_paged_16 and fa_pod,
each a whole async engine step replaying its graph, under
``torch.cuda.set_sync_debug_mode("error")``, kernel A launching once per
layer and step by the counters (which count replays); the first replay of
each signature (decode-only, mixed, fused through F, paged) equal to the
eager step bit for bit; one graph per signature met, no device allocation
in a replay, the decode scratch never replaced; and the sampling modes
replaying with the generator registered.

The serving entry points: the OpenAI server over AsyncLLMEngine answers
on the card (plain, streamed, logprobs) with the tokens of the
synchronous-API engine on the same weights, kernels A, B and C launched
from the engine's own thread; the native allocator core is the default
there; ``load_safetensors`` copies a checkpoint onto the card bit for bit
(and casts a float32 checkpoint into a bf16 model as ``.to`` does).

The benchmark package: ``main --test`` on fa_vattn_2mb and fa_pod
completes every request with no CUDA graph captured in its timed loop.

Sliding windows: every kernel of both bodies against its windowed plain
version at windows 1-300 (the edge cases at 1, 63, 64, 65 and 300, also
on 1-byte arenas), with the same bit-for-bit identities, C captured in a
CUDA graph under a window, and a window past every depth giving the
unwindowed bits (B on the runs' real rows, C on every slot).
"""

import numpy as np
import pytest
import torch

from vattention_tpu_torch.microbenchmarks.decode_edges import (
    check_decode_edges)
from vattention_tpu_torch.microbenchmarks.prefill_edges import (
    check_prefill_edges)
from vattention_tpu_torch.ops.arena_copy import (arena_relocate,
                                                 arena_relocate_plain)
from vattention_tpu_torch.ops.cache_append import kv_append, kv_append_plain
from vattention_tpu_torch.microbenchmarks.timing import check_attention
from vattention_tpu_torch.ops.flash_decode import (DECODE_ATTENTION,
                                                   decode_attention,
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
from vattention_tpu_torch.ops.utils import (quantize_kv,
                                            tile_rows_from_segments)

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


# depths at kernel C's tile (64 positions) and split edges
EDGE_DEPTHS = [1, 63, 64, 65, 255, 256, 257]


def _decode_case(case, dtype, group, sub, device):
    """Inputs of kernel C for one case: "edges" (the edge depths, idle
    slots, and every slot's table 4096 positions deep, far past most live
    depths), "idle" (every slot idle) or "deep" (one slot at 32768 among
    short ones); each slot's table a seeded permutation of the arena's
    ``sub``-row blocks."""
    rng = np.random.default_rng(9)
    depths = {"edges": [500, 1000, 3, 0] + EDGE_DEPTHS + [0, 5],
              "idle": [0] * 6,
              "deep": [32768, 1, 0, 300]}[case]
    rows = 32768 + 1024 if case == "deep" else R
    cache = torch.from_numpy(rng.standard_normal(
        (1, 2, HKV, rows, D)).astype(np.float32)).to(device=device,
                                                     dtype=dtype)
    width = max(4096, max(depths)) // sub
    tile_rows = torch.from_numpy(np.stack([
        rng.permutation(rows // sub)[:width] * sub for _ in depths]).astype(
            np.int32))
    q = torch.from_numpy(rng.standard_normal(
        (len(depths), HKV * group, D)).astype(np.float32)).to(dtype)
    return q, cache, tile_rows, torch.tensor(depths, dtype=torch.int32)


@pytest.mark.parametrize("case", ["edges", "idle", "deep"])
@pytest.mark.parametrize("sub", [16, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 71])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(dev, dtype, group, sub, case):
    """Kernel C against its plain version at tile and split edges, with
    idle slots (exactly zero) and tables far deeper than the live depth;
    float32 within 1e-4, bfloat16 with ``check_attention`` (2e-2 and each
    slot within 2^-6 of its largest output)."""
    q, cache, tile_rows, seqlens = _decode_case(case, dtype, group, sub,
                                                dev)
    kw = dict(sub=sub, sm_scale=D ** -0.5)
    expect = decode_attention_plain(q, cache.cpu(), tile_rows, seqlens, 0,
                                    **kw)
    got = decode_attention(q.to(dev), cache, tile_rows.to(dev),
                           seqlens.to(dev), 0, **kw)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isfinite(got).all()
    for b, n in enumerate(seqlens.tolist()):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
        elif dtype == torch.float32:
            torch.testing.assert_close(got[b], expect[b], atol=1e-4,
                                       rtol=1e-4)
        else:
            check_attention(f"C slot {b} at depth {n}", got[b:b + 1],
                            expect[b:b + 1])


@pytest.mark.parametrize("plan", [(1, 1), (1, 2), (16, 2), (4, 4), (2, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_other_plan_points(dev, dtype, plan):
    """Kernel C with ``min_split_tiles`` and ``blocks_per_sm`` off their
    defaults (``bench_decode_kernel``'s sweep) against its plain version:
    other splits and grids, the same attention; each point's grid is its
    own, never the default's."""
    from vattention_tpu_torch.ops.flash_decode import decode_grid

    m, bps = plan
    q, cache, tile_rows, seqlens = _decode_case("edges", dtype, 8, 16, dev)
    kw = dict(sub=16, sm_scale=D ** -0.5)
    expect = decode_attention_plain(q, cache.cpu(), tile_rows, seqlens, 0,
                                    **kw)
    got = decode_attention(q.to(dev), cache, tile_rows.to(dev),
                           seqlens.to(dev), 0, min_split_tiles=m,
                           blocks_per_sm=bps, **kw)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert decode_grid(dev, bps) == min(bps * sms, 1024)
    got = got.cpu()
    for b, n in enumerate(seqlens.tolist()):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
        elif dtype == torch.float32:
            torch.testing.assert_close(got[b], expect[b], atol=1e-4,
                                       rtol=1e-4)
        else:
            check_attention(f"C plan {plan} slot {b} at depth {n}",
                            got[b:b + 1], expect[b:b + 1])


def test_decode_attention_ignores_table_depth(dev):
    """Kernel C's grid and split plan come from the depths alone: the same
    slots through row tables 4096 and 32768 positions deep give the same
    output bit for bit."""
    q, cache, tile_rows, seqlens = _decode_case("edges", torch.bfloat16, 8,
                                                16, dev)
    deep = torch.cat([tile_rows, tile_rows.repeat(1, 7)], 1).contiguous()
    kw = dict(sub=16, sm_scale=D ** -0.5)
    args = (q.to(dev), cache)
    a = decode_attention(*args, tile_rows.to(dev), seqlens.to(dev), 0, **kw)
    b = decode_attention(*args, deep.to(dev), seqlens.to(dev), 0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_captures_in_a_cuda_graph(dev, window):
    """Kernel C's wrapper reads nothing back from the device: its call
    captures in a CUDA graph, one launch, and a replay after new depths
    are written to ``seqlens`` plans over those depths on the device (under
    a sliding window too: the plan's first tiles come from the depths)."""
    q, cache, tile_rows, seqlens = _decode_case("edges", torch.bfloat16, 8,
                                                16, dev)
    args = [q.to(dev), cache, tile_rows.to(dev), seqlens.to(dev), 0]
    kw = dict(sub=16, sm_scale=D ** -0.5, window=window)
    decode_attention(*args, **kw)   # builds the kernel and its scratch
    torch.cuda.synchronize()
    before = DECODE_ATTENTION.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = decode_attention(*args, **kw)
    assert DECODE_ATTENTION.launches == before + 1
    new = seqlens.flip(0).clone()
    args[3].copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    expect = decode_attention_plain(q, cache.cpu(), tile_rows, new, 0, **kw)
    for b, n in enumerate(new.tolist()):
        if n == 0:
            assert torch.equal(got[b].cpu(), torch.zeros_like(expect[b]))
        else:
            check_attention(f"graph replay, slot {b} at depth {n}",
                            got[b:b + 1].cpu(), expect[b:b + 1])


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


@pytest.mark.parametrize("hq", [8, 16, 142])
def test_prefill_body_edge_cases(dev, hq):
    """The bf16 prefill body at G = 4, 8 and 71 (32- and 16-token q tiles;
    at 71, 128-row blocks that end inside a token):
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


# ---------------------------------------------------------------------- #
# Falcon-7B's attention geometry: G = 71
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arena", [None, torch.float8_e4m3fn, torch.int8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_falcon_kernels_match_plain(dev, dtype, arena):
    """71 query heads on 1 kv head (the arena's 128 lanes, sm_scale of head
    dim 64), over an arena of the model's dtype (``arena`` None), e4m3 or
    int8: B over two runs and the empty run (the flattened (token, head)
    rows end inside tokens), E over poisoned 16-token block tables, C over
    a batch with an idle slot, F on B's and C's inputs (= B then C), G over
    unaligned extents (= B on the same rows) and H (= E on one run), each
    against its plain version."""
    hq = 71
    rng = np.random.default_rng(13)
    cache = torch.from_numpy(rng.standard_normal(
        (1, 2, 1, R, D)).astype(np.float32)).to(dev)
    cache = cache.to(dtype) if arena is None else _quant(cache, arena)
    cpu = cache.cpu()
    sm = 64 ** -0.5 * _step(arena)
    pad = 128
    extents = [[(256, 256), (1024, 512)], [(2048, 256)], []]
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    tile_rows = torch.from_numpy(_tables(extents, R // SUB))
    q = torch.from_numpy(
        rng.standard_normal((4 * pad, hq, D)).astype(np.float32)).to(dtype)
    kw = dict(sub=SUB, pad_tile=pad, sm_scale=sm)
    expect = prefill_attention_plain(q, cpu, qt_run, qinfo, tile_rows, 0,
                                     **kw)
    b_args = (q.to(dev), cache, qt_run.to(dev), qinfo.to(dev),
              tile_rows.to(dev), 0)
    got_b = prefill_attention(*b_args, **kw)
    torch.cuda.synchronize()
    assert not got_b[3 * pad:].float().any()
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        _close("B", got_b[lo:hi], expect[lo:hi], dtype, arena)

    bs = 16
    n = -(-500 // bs)
    tables = torch.full((3, n + 2), 2 ** 30, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(R // bs).astype(np.int32))
    tables[0, :n], tables[1, :4] = perm[:n], perm[n:n + 4]
    ekw = dict(block_size=bs, pad_tile=pad, sm_scale=sm)
    expect = paged_prefill_attention_plain(q, cpu, qt_run, qinfo, tables, 0,
                                           **ekw)
    got = paged_prefill_attention(q.to(dev), cache, qt_run.to(dev),
                                  qinfo.to(dev), tables.to(dev), 0, **ekw)
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        _close("E", got[lo:hi], expect[lo:hi], dtype, arena)

    dec_extents = [[(0, 512)], [(512, 256), (1280, 768)], [(2048, 256)],
                   [(3072, 512)]]
    seqlens = torch.tensor([500, 1000, 0, 3], dtype=torch.int32)
    dec_rows = torch.from_numpy(_tables(dec_extents, R // SUB))
    qd = torch.from_numpy(
        rng.standard_normal((4, hq, D)).astype(np.float32)).to(dtype)
    expect_d = decode_attention_plain(qd, cpu, dec_rows, seqlens, 0, sub=SUB,
                                      sm_scale=sm)
    got_c = decode_attention(qd.to(dev), cache, dec_rows.to(dev),
                             seqlens.to(dev), 0, sub=SUB, sm_scale=sm)
    f_p, f_d = pod_attention(q.to(dev), qd.to(dev), cache, qt_run.to(dev),
                             qinfo.to(dev), tile_rows.to(dev),
                             dec_rows.to(dev), seqlens.to(dev), 0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_c[2], torch.zeros_like(got_c[2]))
    for b in (0, 1, 3):
        _close(f"C slot {b}", got_c[b:b + 1], expect_d[b:b + 1], dtype,
               arena)
    assert torch.equal(f_p, got_b) and torch.equal(f_d, got_c)

    seg_row = np.zeros(8, np.int32)
    seg_cum = np.zeros(9, np.int32)
    for j, (row, k) in enumerate([(2051, 300), (517, 77), (3601, 123)]):
        seg_row[j], seg_cum[j + 1] = row, seg_cum[j] + k
    seg_cum[4:] = seg_cum[3]
    info = torch.tensor([300, 500], dtype=torch.int32)
    q2 = q[:256]
    sr, sc = torch.from_numpy(seg_row), torch.from_numpy(seg_cum)
    expect = segment_prefill_attention_plain(q2, cpu, sr, sc, info, 0,
                                             sm_scale=sm)
    got = segment_prefill_attention(q2.to(dev), cache, sr.to(dev),
                                    sc.to(dev), info.to(dev), 0, sm_scale=sm)
    rows = torch.from_numpy(tile_rows_from_segments(
        seg_row[None], seg_cum[None], 1, 500)).to(dev)
    qt2 = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32, device=dev)
    got_g_b = prefill_attention(q2.to(dev), cache, qt2, info.to(dev)[None],
                                rows, 0, sub=1, pad_tile=pad, sm_scale=sm)
    _close("G", got, expect, dtype, arena)
    table = tables[0].to(dev)
    got_h = paged_prefill_attention_single(q2.to(dev), cache, table,
                                           info.to(dev), 0, block_size=bs,
                                           sm_scale=sm)
    got_e = paged_prefill_attention(q2.to(dev), cache, qt2,
                                    info.to(dev)[None], table[None], 0,
                                    **ekw)
    expect = paged_prefill_attention_single_plain(q2, cpu, tables[0], info,
                                                  0, block_size=bs,
                                                  sm_scale=sm)
    torch.cuda.synchronize()
    assert torch.equal(got, got_g_b) and torch.equal(got_h, got_e)
    _close("H", got_h, expect, dtype, arena)


# ---------------------------------------------------------------------- #
# 1-byte arenas
# ---------------------------------------------------------------------- #
QUANT = [torch.float8_e4m3fn, torch.int8]
STEP = 0.04


def _quant(cache, arena):
    """A float arena (any device) as kernel A would write it."""
    return quantize_kv(cache.float(), arena, STEP)


def _sm(arena):
    return D ** -0.5 * _step(arena)


def _step(arena):
    """An int8 arena's step (its scores and outputs count in it), else 1."""
    return STEP if arena == torch.int8 else 1.0


def _append_values(rng, T, src):
    x = (rng.standard_normal((T, HKV, D)) * 3).astype(np.float32)
    cut = 15.0 * 2.0 ** -10
    special = np.float32([cut, np.nextafter(np.float32(cut), 0), 448, 447,
                          464, 500, 1000, 0.5 * STEP, 1.5 * STEP,
                          126.5 * STEP, 200 * STEP, 2.0 ** -9])
    special = np.concatenate([special, -special])
    x.reshape(-1)[rng.permutation(x.size)[:special.size]] = special
    return torch.from_numpy(x).to(src)


@pytest.mark.parametrize("arena", QUANT)
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_kv_append_quantizes_as_plain(dev, src, arena):
    rng = np.random.default_rng(10)
    cache = _quant(_cache(rng, torch.float32, dev), arena)
    T = 40
    k, v = _append_values(rng, T, src), _append_values(rng, T, src)
    rows = rng.permutation(R)[:T].astype(np.int32)
    rows[::7] = -1
    rows = torch.from_numpy(rows)
    scale = STEP if arena == torch.int8 else None
    expect = cache.cpu()
    kv_append_plain(expect, k, v, rows, 1, scale)
    kv_append(cache, k.to(dev), v.to(dev), rows.to(dev), 1, kv_scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(cache.cpu().view(torch.uint8),
                       expect.view(torch.uint8))


@pytest.mark.parametrize("arena", QUANT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_body_widens_every_pattern_exactly(dev, dtype, arena):
    """Row 0's V holds every finite e4m3 pattern (or every int8 value);
    zero queries at kv_len 1 give that key weight 1, so every output row
    of C, B, E, G, H and F is V's row widened, exactly."""
    if arena == torch.float8_e4m3fn:
        pats = [b for b in range(256) if b & 0x7F != 0x7F] + [0, 0]
        vals = torch.tensor(pats, dtype=torch.uint8).view(arena)
    else:
        vals = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    cache = torch.zeros((1, 2, HKV, R, D), dtype=arena)
    cache[0, 1, :, 0] = vals.view(HKV, D)
    expect = cache[0, 1, :, 0].to(dtype)                     # [HKV, D]
    expect = expect.repeat_interleave(HQ // HKV, 0)          # [HQ, D]
    cache = cache.to(dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    sm = _sm(arena)
    qp = torch.zeros((128, HQ, D), dtype=dtype, device=dev)
    qd = torch.zeros((2, HQ, D), dtype=dtype, device=dev)
    qinfo, qt_run = i32([[0, 1]]), i32([[0, 0]])
    table, rows = i32([[0]]), i32([[0], [0]])
    outs = {
        "C": decode_attention(qd, cache, rows, i32([1, 1]), 0, sub=SUB,
                              sm_scale=sm),
        "B": prefill_attention(qp, cache, qt_run, qinfo, table, 0, sub=SUB,
                               pad_tile=128, sm_scale=sm),
        "E": paged_prefill_attention(qp, cache, qt_run, qinfo, table, 0,
                                     block_size=16, pad_tile=128,
                                     sm_scale=sm),
        "G": segment_prefill_attention(qp, cache, i32([0]), i32([0, 1]),
                                       i32([0, 1]), 0, sm_scale=sm),
        "H": paged_prefill_attention_single(qp, cache, i32([0]),
                                            i32([0, 1]), 0, block_size=16,
                                            sm_scale=sm)}
    outs["F prefill"], outs["F decode"] = pod_attention(
        qp, qd, cache, qt_run, qinfo, table, rows, i32([1, 1]), 0, sub=SUB,
        pad_tile=128, sm_scale=sm)
    torch.cuda.synchronize()
    for name, out in outs.items():
        out = out.cpu()
        for row in range(out.shape[0]):
            assert torch.equal(out[row], expect), (name, row)


@pytest.mark.parametrize("arena", QUANT)
@pytest.mark.parametrize("sub", [16, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 71])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_decode_attention_matches_plain(dev, dtype, group, sub,
                                                  arena):
    q, cache, tile_rows, seqlens = _decode_case("edges", dtype, group, sub,
                                                dev)
    cache = _quant(cache, arena)
    kw = dict(sub=sub, sm_scale=_sm(arena))
    expect = decode_attention_plain(q, cache.cpu(), tile_rows, seqlens, 0,
                                    **kw)
    got = decode_attention(q.to(dev), cache, tile_rows.to(dev),
                           seqlens.to(dev), 0, **kw)
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isfinite(got).all()
    s = _step(arena)
    for b, n in enumerate(seqlens.tolist()):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
        elif dtype == torch.float32:
            torch.testing.assert_close(got[b] * s, expect[b] * s, atol=1e-4,
                                       rtol=1e-4)
        else:
            check_attention(f"C slot {b} at depth {n}", got[b:b + 1],
                            expect[b:b + 1], scale=s)


def _close(what, got, expect, dtype, arena):
    """Outputs compared after the backend's multiply by an int8 step."""
    s = _step(arena)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu() * s, expect * s, atol=1e-4,
                                   rtol=1e-4)
    else:
        check_attention(what, got.cpu(), expect, scale=s)


@pytest.mark.parametrize("arena", QUANT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_prefill_kernels_match_plain(dev, dtype, arena):
    """B over two runs (then the empty run), E over 16-token blocks, G over
    unaligned extents (= B on the same rows) and H (= E on one run), each
    against its plain version on a 1-byte arena."""
    rng = np.random.default_rng(11)
    cache = _quant(_cache(rng, torch.float32, dev), arena)
    cpu = cache.cpu()
    sm = _sm(arena)
    pad = 128
    extents = [[(256, 256), (1024, 512)], [(2048, 256)], []]
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    tile_rows = torch.from_numpy(_tables(extents, R // SUB))
    q = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    b_args = (q, cpu, qt_run, qinfo, tile_rows, 0)
    kw = dict(sub=SUB, pad_tile=pad, sm_scale=sm)
    expect = prefill_attention_plain(*b_args, **kw)
    got = prefill_attention(*(x.to(dev) for x in b_args[:-1]), 0, **kw)
    assert not got[3 * pad:].float().any()
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        _close("B", got[lo:hi], expect[lo:hi], dtype, arena)

    bs = 16
    n = -(-500 // bs)
    tables = torch.full((3, n + 2), 2 ** 30, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(R // bs).astype(np.int32))
    tables[0, :n], tables[1, :4] = perm[:n], perm[n:n + 4]
    ekw = dict(block_size=bs, pad_tile=pad, sm_scale=sm)
    e_args = (q, cpu, qt_run, qinfo, tables, 0)
    expect = paged_prefill_attention_plain(*e_args, **ekw)
    got = paged_prefill_attention(*(x.to(dev) for x in e_args[:-1]), 0,
                                  **ekw)
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        _close("E", got[lo:hi], expect[lo:hi], dtype, arena)

    # G over unaligned extents and B at one row per entry; H against E
    seg_row = np.zeros(8, np.int32)
    seg_cum = np.zeros(9, np.int32)
    for j, (row, k) in enumerate([(2051, 300), (517, 77), (3601, 123)]):
        seg_row[j], seg_cum[j + 1] = row, seg_cum[j] + k
    seg_cum[4:] = seg_cum[3]
    info = torch.tensor([300, 500], dtype=torch.int32)
    q2 = q[:256]
    sr, sc = torch.from_numpy(seg_row), torch.from_numpy(seg_cum)
    expect = segment_prefill_attention_plain(q2, cpu, sr, sc, info, 0,
                                             sm_scale=sm)
    got = segment_prefill_attention(q2.to(dev), cache, sr.to(dev),
                                    sc.to(dev), info.to(dev), 0, sm_scale=sm)
    rows = torch.from_numpy(tile_rows_from_segments(
        seg_row[None], seg_cum[None], 1, 500)).to(dev)
    qt2 = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32, device=dev)
    got_b = prefill_attention(q2.to(dev), cache, qt2, info.to(dev)[None],
                              rows, 0, sub=1, pad_tile=pad, sm_scale=sm)
    _close("G", got, expect, dtype, arena)
    table = tables[0].to(dev)
    got_h = paged_prefill_attention_single(q2.to(dev), cache, table,
                                           info.to(dev), 0, block_size=bs,
                                           sm_scale=sm)
    got_e = paged_prefill_attention(q2.to(dev), cache, qt2,
                                    info.to(dev)[None], table[None], 0,
                                    **ekw)
    expect = paged_prefill_attention_single_plain(q2, cpu, tables[0], info,
                                                  0, block_size=bs,
                                                  sm_scale=sm)
    torch.cuda.synchronize()
    assert torch.equal(got, got_b) and torch.equal(got_h, got_e)
    _close("H", got_h, expect, dtype, arena)


@pytest.mark.parametrize("arena", QUANT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_pod_attention_equals_b_then_c(dev, dtype, arena):
    rng = np.random.default_rng(12)
    cache = _quant(_cache(rng, torch.float32, dev), arena)
    pad = 128
    sm = _sm(arena)
    qinfo = torch.tensor([[300, 500], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    pre_rows = torch.from_numpy(_tables(
        [[(256, 256), (1024, 512)], [(2048, 256)], []], R // SUB))
    seqlens = torch.tensor([500, 1000, 0, 3], dtype=torch.int32)
    dec_rows = torch.from_numpy(_tables(
        [[(0, 512)], [(512, 256), (1280, 768)], [(2048, 256)],
         [(3072, 512)]], R // SUB))
    qp = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    qd = torch.from_numpy(
        rng.standard_normal((4, HQ, D)).astype(np.float32)).to(dtype)
    kw = dict(sub=SUB, pad_tile=pad, sm_scale=sm)
    exp_p, exp_d = pod_attention_plain(qp, qd, cache.cpu(), qt_run, qinfo,
                                       pre_rows, dec_rows, seqlens, 1, **kw)
    args = (qp.to(dev), qd.to(dev), cache, qt_run.to(dev), qinfo.to(dev),
            pre_rows.to(dev), dec_rows.to(dev), seqlens.to(dev), 1)
    got_p, got_d = pod_attention(*args, **kw)
    b = prefill_attention(args[0], cache, args[3], args[4], args[5], 1, **kw)
    c = decode_attention(args[1], cache, args[6], args[7], 1, sub=SUB,
                         sm_scale=sm)
    torch.cuda.synchronize()
    assert torch.equal(got_p, b) and torch.equal(got_d, c)
    for lo, hi in ((0, 200), (2 * pad, 2 * pad + 60)):
        _close("F prefill", got_p[lo:hi], exp_p[lo:hi], dtype, arena)
    _close("F decode", got_d, exp_d, dtype, arena)


@pytest.mark.parametrize("arena", QUANT)
def test_arena_relocate_moves_one_byte_rows(dev, arena):
    rng = np.random.default_rng(13)
    cache = _quant(_cache(rng, torch.float32, dev), arena)
    src = torch.tensor([3, 1, 7, 0], dtype=torch.int32)
    dst = torch.tensor([5, 3, 1, 7], dtype=torch.int32)
    expect = cache.cpu()
    arena_relocate_plain(expect, src, dst, 4, 256)
    arena_relocate(cache, src.to(dev), dst.to(dev), 4, 256)
    torch.cuda.synchronize()
    assert torch.equal(cache.cpu().view(torch.uint8),
                       expect.view(torch.uint8))


@pytest.mark.parametrize("arena", QUANT)
def test_quantized_body_edge_cases(dev, arena):
    """The edge cases of the bf16 prefill and decode bodies on a 1-byte
    arena (G = 8)."""
    rng = np.random.default_rng(14)
    cache = _quant(torch.from_numpy(
        rng.standard_normal((1, 2, HKV, 32768, D)).astype(np.float32)
    ).to(dev), arena)
    check_prefill_edges(cache, 16, 0, sm_scale=_sm(arena),
                        out_scale=_step(arena))
    check_decode_edges(cache, 0, sm_scale=_sm(arena), out_scale=_step(arena))


# ---------------------------------------------------------------------- #
# sliding windows
# ---------------------------------------------------------------------- #
WINDOWS = [1, 63, 64, 65, 300]


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_body_edge_cases(dev, window):
    """The bf16 prefill and decode bodies' edge cases under a sliding
    window (G = 4): B against its plain version, E = B, F = B then C,
    G = B and H = E bit for bit; C at depths around the window and the
    64-position tiles, every group, 16- and 256-row entries, idle slots
    exactly zero."""
    rng = np.random.default_rng(15)
    cache = torch.from_numpy(
        rng.standard_normal((1, 2, HKV, 32768, D)).astype(np.float32)
    ).to(device=dev, dtype=torch.bfloat16)
    check_prefill_edges(cache, 8, 0, window=window)
    check_decode_edges(cache, 0, window=window)


@pytest.mark.parametrize("window", [1, 65, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernels_match_plain(dev, dtype, window):
    """B, C, E, G, H and F under a sliding window against their windowed
    plain versions (float32 1e-4, bfloat16 2e-2 on the runs' real rows),
    with G = B, H = E and F = B then C bit for bit; and with a window past
    every depth B and C give their unwindowed bits."""
    rng = np.random.default_rng(16)
    cache = _cache(rng, dtype, dev)
    pad, bs = 128, 16
    extents = [[(256, 256), (1024, 512)], [(2048, 256)], []]
    qinfo = torch.tensor([[500, 700], [0, 60], [0, 0]], dtype=torch.int32)
    qt_run = torch.tensor([[0, 0], [0, 1], [1, 0], [2, 0]],
                          dtype=torch.int32)
    rows = torch.from_numpy(_tables(extents, R // SUB))
    dec_extents = [[(0, 512)], [(512, 256), (1280, 768)], [(2048, 256)],
                   [(3072, 512)]]
    seqlens = torch.tensor([500, 1000, 0, window + 1], dtype=torch.int32)
    dec_rows = torch.from_numpy(_tables(dec_extents, R // SUB))
    qp = torch.from_numpy(
        rng.standard_normal((4 * pad, HQ, D)).astype(np.float32)).to(dtype)
    qd = torch.from_numpy(
        rng.standard_normal((4, HQ, D)).astype(np.float32)).to(dtype)
    # block tables naming each run's rows, for E and H
    tables = torch.zeros((3, 700 // bs + 1), dtype=torch.int32)
    for r, n in enumerate(qinfo[:, 1].tolist()):
        pos = torch.arange(0, n, bs)
        tables[r, :len(pos)] = (rows[r].long()[pos // SUB] + pos % SUB) // bs
    kw = dict(pad_tile=pad, sm_scale=D ** -0.5, window=window)
    on = [x.to(dev) for x in (qp, qd, qt_run, qinfo, rows, dec_rows,
                              seqlens, tables)]
    dqp, dqd, dqt, dqi, drows, ddec, dseq, dtab = on
    b = prefill_attention(dqp, cache, dqt, dqi, drows, 1, sub=SUB, **kw)
    c = decode_attention(dqd, cache, ddec, dseq, 1, sub=SUB,
                         sm_scale=D ** -0.5, window=window)
    e = paged_prefill_attention(dqp, cache, dqt, dqi, dtab, 1,
                                block_size=bs, **kw)
    f_p, f_d = pod_attention(dqp, dqd, cache, dqt, dqi, drows, ddec, dseq,
                             1, sub=SUB, **kw)
    seg_row = torch.tensor([256, 1024], dtype=torch.int32, device=dev)
    seg_cum = torch.tensor([0, 256, 768], dtype=torch.int32, device=dev)
    one = dqi[0].clone()
    g = segment_prefill_attention(dqp[:2 * pad], cache, seg_row, seg_cum,
                                  one, 1, sm_scale=D ** -0.5, window=window)
    h = paged_prefill_attention_single(dqp[:2 * pad], cache,
                                       dtab[0].clone(), one, 1,
                                       block_size=bs, sm_scale=D ** -0.5,
                                       window=window)
    wide = 4096   # past every depth here
    b_wide = prefill_attention(dqp, cache, dqt, dqi, drows, 1, sub=SUB,
                               **{**kw, "window": wide})
    b_none = prefill_attention(dqp, cache, dqt, dqi, drows, 1, sub=SUB,
                               **{**kw, "window": None})
    c_wide = decode_attention(dqd, cache, ddec, dseq, 1, sub=SUB,
                              sm_scale=D ** -0.5, window=wide)
    c_none = decode_attention(dqd, cache, ddec, dseq, 1, sub=SUB,
                              sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(e, b) and torch.equal(f_p, b) and torch.equal(f_d, c)
    assert torch.equal(g, b[:2 * pad]) and torch.equal(h, e[:2 * pad])
    assert torch.equal(c_wide, c_none)
    real = [(0, 200), (2 * pad, 2 * pad + 60)]
    for lo, hi in real:
        assert torch.equal(b_wide[lo:hi], b_none[lo:hi])
    exp_b = prefill_attention_plain(qp, cache.cpu(), qt_run, qinfo, rows, 1,
                                    sub=SUB, **kw)
    exp_c = decode_attention_plain(qd, cache.cpu(), dec_rows, seqlens, 1,
                                   sub=SUB, sm_scale=D ** -0.5,
                                   window=window)
    exp_e = paged_prefill_attention_plain(qp, cache.cpu(), qt_run, qinfo,
                                          tables, 1, block_size=bs, **kw)
    b, c, e = b.cpu(), c.cpu(), e.cpu()
    assert torch.equal(b[3 * pad:], torch.zeros_like(b[3 * pad:]))
    assert torch.equal(c[2], torch.zeros_like(c[2]))
    tol = TOL[dtype]
    for lo, hi in real:
        torch.testing.assert_close(b[lo:hi].float(), exp_b[lo:hi].float(),
                                   atol=tol, rtol=tol)
    torch.testing.assert_close(e[:200].float(), exp_e[:200].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(c.float(), exp_c.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arena", QUANT)
def test_quantized_windowed_edge_cases(dev, arena):
    """The windowed edge cases of both bodies on a 1-byte arena (G = 8,
    window 65)."""
    rng = np.random.default_rng(17)
    cache = _quant(torch.from_numpy(
        rng.standard_normal((1, 2, HKV, 32768, D)).astype(np.float32)
    ).to(dev), arena)
    check_prefill_edges(cache, 16, 0, sm_scale=_sm(arena),
                        out_scale=_step(arena), window=65)
    check_decode_edges(cache, 0, sm_scale=_sm(arena), out_scale=_step(arena),
                       window=65)


# ---------------------------------------------------------------------- #
# kernel A with the rotation (rope_kv_append)
# ---------------------------------------------------------------------- #
ROPE_SCALINGS = {
    "plain": None,
    "linear4": {"type": "linear", "factor": 4.0},
    # 1/3 is inexact: the kernel multiplies by PyTorch's float32 reciprocal
    "linear3": {"type": "linear", "factor": 3.0},
    "dynamic": {"type": "dynamic", "factor": 2.0},
    "yarn": {"type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 4096},
}


def _rope_case(rng, T, head_dim, dtype, arena, dev):
    """qkv [T, (HQ + 2 HKV) * head_dim], positions to 200K (cosf's slow
    range reduction included), rows with -1 every 5th token, and an
    arena of dtype ``arena`` (None: the model's) with D-wide heads."""
    qkv = torch.from_numpy(
        (rng.standard_normal((T, (HQ + 2 * HKV) * head_dim)) * 3
         ).astype(np.float32)).to(dev, dtype)
    pos = torch.from_numpy(rng.integers(0, 200_000, T).astype(np.int32))
    pos[:4] = torch.tensor([0, 1, 4095, 131071], dtype=torch.int32)[:T]
    rows = rng.permutation(R)[:T].astype(np.int32)
    rows[::5] = -1
    cache = _cache(rng, torch.float32, dev)
    cache = cache.to(dtype) if arena is None else _quant(cache, arena)
    return qkv, pos.to(dev), torch.from_numpy(rows).to(dev), cache


@pytest.mark.parametrize("head_dim", [128, 64])
@pytest.mark.parametrize("arena", [None, *QUANT])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaling", list(ROPE_SCALINGS))
def test_rope_kv_append_matches_plain(dev, scaling, dtype, arena, head_dim):
    """Kernel A with the rotation against its plain version (the rope,
    then kv_append_plain) on the card, bit for bit: q for every token, the
    arena (zeros past head_dim 64), 1-byte arenas quantized alike."""
    from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
        get_rope)
    from vattention_tpu_torch.ops.cache_append import (rope_kv_append,
                                                       rope_kv_append_plain)

    rng = np.random.default_rng(20)
    qkv, pos, rows, cache = _rope_case(rng, 70, head_dim, dtype, arena, dev)
    rope = get_rope(head_dim, head_dim, 8192, 5e6, ROPE_SCALINGS[scaling])
    step = STEP if arena == torch.int8 else None
    expect = cache.clone()
    q_ref = rope_kv_append_plain(expect, qkv, pos, rows, 1, rope, step)
    q = rope_kv_append(cache, qkv, pos, rows, 1, rope, step)
    torch.cuda.synchronize()
    assert torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
    assert torch.equal(cache.view(torch.uint8), expect.view(torch.uint8))


def test_rope_kv_append_captures_in_a_cuda_graph(dev):
    """A's wrapper reads nothing back from the device: its call captures
    in a CUDA graph, one launch, and a replay after new positions and
    rows are written rotates and writes at those."""
    from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
        get_rope)
    from vattention_tpu_torch.ops.cache_append import (ROPE_KV_APPEND,
                                                       rope_kv_append,
                                                       rope_kv_append_plain)

    rng = np.random.default_rng(21)
    qkv, pos, rows, cache = _rope_case(rng, 40, D, torch.bfloat16, None, dev)
    rope = get_rope(D, D, 8192, 5e6, None)
    start = cache.clone()
    rope_kv_append(cache, qkv, pos, rows, 0, rope)  # builds, copies inv_freq
    torch.cuda.synchronize()
    before = ROPE_KV_APPEND.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q = rope_kv_append(cache, qkv, pos, rows, 1, rope)
    assert ROPE_KV_APPEND.launches == before + 1
    new_pos = pos.flip(0).clone()
    new_rows = rows.roll(3).clone()
    pos.copy_(new_pos)
    rows.copy_(new_rows)
    cache.copy_(start)
    graph.replay()
    torch.cuda.synchronize()
    expect = start.clone()
    q_ref = rope_kv_append_plain(expect, qkv, new_pos, new_rows, 1, rope)
    assert torch.equal(q, q_ref)
    assert torch.equal(cache[1], expect[1])


def _engine(model="tiny-llama-debug", backend="fa_vattn", **kw):
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    args = dict(model=model, dtype="bfloat16", attention_backend=backend,
                scheduler_type="sarathi", max_model_len=512,
                max_batch_size=4, max_num_seqs=4, chunk_size=128,
                gpu_memory_utilization=0.05)
    args.update(kw)
    return LLMEngine.from_engine_args(**args)


def _free(engine):
    import gc

    engine.cleanup()
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("model", ["tiny-llama-debug", "tiny-mistral-debug",
                                   "tiny-d64-debug"])
@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
def test_run_layers_does_not_synchronize(dev, backend, model):
    """Whole async engine steps -- a prompt's, a mixed step (one prompt's
    chunk beside another's decode) and a decode step, each a replay of its
    captured graph -- run under torch.cuda.set_sync_debug_mode("error"):
    nothing from the input staging through the replay to the next
    dispatch synchronizes a stream.  Kernel A launches once per layer and
    step (the counters count replays)."""
    from vattention_tpu_torch.microbenchmarks.captured_step import (
        check_step_does_not_sync)

    engine = _engine(model, backend)
    try:
        layers = engine.worker.model_runner.model.arch.num_layers
        assert check_step_does_not_sync(engine) == [layers] * 3
    finally:
        _free(engine)


# prompts that meet a prompt's steps, mixed steps (the first request
# decoding beside the second's chunks) and decode-only steps
_GRAPH_REQUESTS = [("g0", list(range(1, 181)), 6),
                   ("g1", list(range(3, 303)), 6)]


@pytest.mark.parametrize("model", ["tiny-llama-debug", "tiny-d64-debug"])
@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
def test_replay_equals_the_eager_step(dev, backend, model):
    """The first replay of each signature -- decode-only, mixed (through
    kernel F on fa_pod), paged -- gives the eager step's samples, arena
    rows and token buffer bit for bit on the same inputs."""
    from vattention_tpu_torch.microbenchmarks.captured_step import (
        check_replays)
    from vattention_tpu_torch.microbenchmarks.serving_profile import serve

    engine = _engine(model, backend)
    try:
        checked = check_replays(engine, _GRAPH_REQUESTS, serve)
        assert checked and all(all(v.values()) for v in checked.values()), \
            checked
        pod = backend == "fa_pod"
        assert (0, False, "greedy") in checked
        assert any(n > 0 and p == pod for n, p, _ in checked), checked
    finally:
        _free(engine)


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16"])
def test_profile_decode_step_replays_the_engines_decode_graph(dev, backend):
    """``captured_step.next_step`` hands back a decode step's staged
    inputs and its graph; ``profile_decode_step.replay_seconds`` replays
    it and puts back the arena rows and the token buffer it wrote, so the
    engine then serves on as if no replay had run."""
    from vattention_tpu_torch.microbenchmarks.captured_step import next_step
    from vattention_tpu_torch.scripts.common import Clock
    from vattention_tpu_torch.scripts.profile_decode_step import (
        prefill, replay_seconds)

    engine = _engine(backend=backend)
    try:
        prefill(engine, 2, 200)
        for _ in range(3):
            engine.step()
        runner = engine.worker.model_runner
        step = next_step(engine)
        assert step["n_pre"] == 0 and step["graph"] is not None
        torch.cuda.synchronize()
        kv = runner.cache_engine.kv_cache.clone()
        tok = runner._tok_buf.clone()
        assert replay_seconds(runner, step, 5, Clock(dev)) > 0
        torch.cuda.synchronize()
        assert torch.equal(runner.cache_engine.kv_cache.view(torch.uint8),
                           kv.view(torch.uint8))
        assert torch.equal(runner._tok_buf, tok)
    finally:
        _free(engine)


def test_bench_decode_kernel_on_the_card(dev):
    """Two plan points of the sweep at a small depth: each checked
    against C's plain version inside the sweep, each with its own grid."""
    from vattention_tpu_torch.microbenchmarks import bench_decode_kernel

    rows = bench_decode_kernel.sweep(bench_decode_kernel.parser().parse_args(
        ["--batch", "3", "--ctx", "5000", "--layers", "4", "--iters", "2",
         "--plans", "4:2", "1:3"]))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert [r["grid"] for r in rows] == [min(2 * sms, 1024),
                                         min(3 * sms, 1024)]
    assert all(r["ms"] > 0 and r["max_abs_err"] < 2e-2 for r in rows)


TINY_FALCON = dict(model_type="falcon", num_hidden_layers=2,
                   num_attention_heads=71, num_key_value_heads=1,
                   head_dim=64, hidden_size=256, intermediate_size=1024,
                   vocab_size=2048, max_position_embeddings=2048,
                   parallel_attn=True)


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
def test_falcon_replay_equals_the_eager_step(dev, backend, tmp_path):
    """A tiny falcon (71 query heads on 1 kv head, bf16, a config.json
    directory): the first replay of each signature equals the eager step
    bit for bit, as for llama."""
    import json

    from vattention_tpu_torch.microbenchmarks.captured_step import (
        check_replays)
    from vattention_tpu_torch.microbenchmarks.serving_profile import serve

    (tmp_path / "config.json").write_text(json.dumps(TINY_FALCON))
    engine = _engine(str(tmp_path), backend)
    try:
        assert engine.worker.model_runner.model.hq == 71
        checked = check_replays(engine, _GRAPH_REQUESTS, serve)
        assert checked and all(all(v.values()) for v in checked.values()), \
            checked
        assert (0, False, "greedy") in checked
        assert any(n > 0 and p == (backend == "fa_pod")
                   for n, p, _ in checked), checked
    finally:
        _free(engine)


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
def test_sync_engine_replays_equal_the_eager_step(dev, backend):
    """With enable_async_execution=False every step is resolved before the
    next (``run = resolve(run_async)``), and still replays its graph: the
    first replay of each signature equals the eager step bit for bit, and
    the tokens equal the async engine's."""
    from vattention_tpu_torch.microbenchmarks.captured_step import (
        check_replays)
    from vattention_tpu_torch.microbenchmarks.serving_profile import serve

    tokens = {}
    for async_execution in (False, True):
        engine = _engine(backend=backend,
                         enable_async_execution=async_execution)
        try:
            assert engine.async_execution is async_execution
            if not async_execution:
                checked = check_replays(engine, _GRAPH_REQUESTS, serve)
                assert checked and all(all(v.values())
                                       for v in checked.values()), checked
                assert (0, False, "greedy") in checked
            tokens[async_execution] = serve(
                engine, [(f"again-{s}", p, n) for s, p, n in _GRAPH_REQUESTS])
        finally:
            _free(engine)
    assert tokens[False] == tokens[True]


def test_graphs_are_bounded_by_the_signatures_met(dev):
    """One graph per signature met, captured once; a replay allocates no
    device memory and the decode scratch the graphs read is never
    replaced."""
    from vattention_tpu_torch.microbenchmarks.serving_profile import serve
    from vattention_tpu_torch.ops.flash_decode import current_scratch

    engine = _engine(backend="fa_pod")
    runner = engine.worker.model_runner
    met = []
    launch = runner._launch

    def spy(inputs, n_pre, mode):
        met.append(runner.signature(inputs, n_pre, mode))
        return launch(inputs, n_pre, mode)
    runner._launch = spy
    try:
        serve(engine, _GRAPH_REQUESTS)
        assert len(runner.graphs) == len(set(met)) < len(met)
        scratch = [t.data_ptr() for t in current_scratch(runner.device)]
        for g in runner.graphs.values():
            assert [t.data_ptr() for t in g.scratch] == scratch
        serve(engine, [(f"h{i}", list(range(5, 5 + n)), 8)
                       for i, n in enumerate((90, 260, 33, 140))])
        assert [t.data_ptr() for t in current_scratch(runner.device)] == scratch
        assert len(runner.graphs) == len(set(met))
        torch.cuda.synchronize()
        graph = runner.graphs[(0, False, "greedy")]
        before = torch.cuda.memory_allocated(dev)
        runner.replay(graph)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == before
    finally:
        del runner._launch
        _free(engine)


def test_sampling_modes_replay_with_the_generator(dev):
    """Sampling and filtering steps capture with the runner's generator
    registered: each replay draws new numbers, and two engines built with
    the same seed sample the same tokens."""
    from vattention_tpu_torch import SamplingParams

    def run():
        engine = _engine()
        params = [SamplingParams(temperature=0.9, max_tokens=8,
                                 ignore_eos=True),
                  SamplingParams(temperature=0.7, top_k=20, top_p=0.9,
                                 max_tokens=8, ignore_eos=True)]
        for i, sp in enumerate(params):
            engine.add_request(prompt=None, seq_id=f"s{i}",
                               prompt_token_ids=list(range(10, 80)),
                               sampling_params=sp)
        out = {}
        while engine.has_unfinished_requests():
            for o in engine.step():
                if o.finished:
                    out[o.seq_id] = o.token_ids
        modes = {sig[2] for sig in engine.worker.model_runner.graphs}
        _free(engine)
        return out, modes

    first, modes = run()
    assert "filter" in modes
    assert all(len(v) == 8 and min(v) >= 0 for v in first.values())
    assert run()[0] == first


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
def test_profile_op_level_on_the_card(dev, backend):
    """The op profiler times every row on the card (CUDA events) through
    the port's kernels, and puts back the arena rows kernel A wrote."""
    engine = _engine(backend=backend)
    try:
        kv = engine.worker.cache_engine.kv_cache.clone()
        ops = engine.worker.profile_op_level(ctx=300, iters=2)
        assert {"attn_prefill", "attn_decode", "attn_kv_cache_save",
                "attn_pre_proj", "mlp_up_proj", "sample"} <= set(ops)
        assert "attn_rope" not in ops and all(v > 0 for v in ops.values())
        torch.cuda.synchronize()
        assert torch.equal(engine.worker.cache_engine.kv_cache.view(
            torch.uint8), kv.view(torch.uint8))
    finally:
        _free(engine)


def test_server_answers_on_the_card(dev):
    """The port's OpenAI server over AsyncLLMEngine on the card: a greedy
    completion, streamed and not, with logprobs, equal to the synchronous
    engine's tokens on the same seeded weights; A, B and C launch."""
    import asyncio
    import json

    from aiohttp.test_utils import TestClient, TestServer

    from vattention_tpu_torch import SamplingParams
    from vattention_tpu_torch.engine.async_llm_engine import AsyncLLMEngine
    from vattention_tpu_torch.entrypoints.openai_server.api_server import (
        OpenAIServer)
    from vattention_tpu_torch.memory.native import NativeVAttentionAllocator
    from vattention_tpu_torch.ops.cache_append import ROPE_KV_APPEND
    from vattention_tpu_torch.ops.flash_prefill import PREFILL_ATTENTION

    prompt = list(range(5, 300))
    sync = _engine()
    try:
        assert type(sync.worker.cache_engine.allocator) is \
            NativeVAttentionAllocator
        sync.add_request(None, SamplingParams(temperature=0.0, max_tokens=6,
                                              ignore_eos=True),
                         prompt_token_ids=prompt, seq_id="s")
        expect = None
        while sync.has_unfinished_requests():
            for o in sync.step():
                if o.finished:
                    expect = o.token_ids
    finally:
        _free(sync)

    eng = AsyncLLMEngine(_engine(max_logprobs=2))
    kernels = (ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION)
    before = [k.launches for k in kernels]

    async def body():
        client = TestClient(TestServer(OpenAIServer(eng, "tiny",
                                                    max_logprobs=2).app()))
        await client.start_server()
        try:
            req = {"model": "tiny", "prompt": prompt, "max_tokens": 6,
                   "temperature": 0.0, "ignore_eos": True, "logprobs": 2}
            r = await client.post("/v1/completions", json=req)
            plain = await r.json()
            r = await client.post("/v1/completions",
                                  json={**req, "stream": True})
            raw = (await r.read()).decode()
            return plain, raw
        finally:
            await client.close()

    try:
        plain, raw = asyncio.new_event_loop().run_until_complete(body())
    finally:
        eng.shutdown()
        _free(eng.engine)
    choice = plain["choices"][0]
    assert json.loads(choice["text"]) == expect
    lps = choice["logprobs"]["token_logprobs"]
    assert len(lps) == 6 and all(x <= 0 for x in lps)
    chunks = [json.loads(line[6:]) for line in raw.splitlines()
              if line.startswith("data: {")]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert all(k.launches > b for k, b in zip(kernels, before))


def test_load_safetensors_copies_onto_the_card(dev, tmp_path):
    """A checkpoint written from seeded bf16 params on the card loads back
    onto the card bit for bit; a float32 checkpoint loads into a bf16
    model as ``.to(torch.bfloat16)`` of the same values."""
    from vattention_tpu_torch.config import ModelConfig, get_model_arch
    from vattention_tpu_torch.microbenchmarks.checkpoint import (
        write_checkpoint)
    from vattention_tpu_torch.model_executor.models import get_model_class
    from vattention_tpu_torch.model_executor.weight_utils import (
        load_safetensors)

    arch = get_model_arch("tiny-llama-debug")
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        model = get_model_class("llama")(arch, dtype=dtype)
        params = model.init_params(dev, seed=3)
        write_checkpoint(model, params, tmp_path / name)
        bf16 = get_model_class("llama")(arch, dtype=torch.bfloat16)
        cfg = ModelConfig(model=str(tmp_path / name),
                          load_format="safetensors", dtype="bfloat16")
        loaded = load_safetensors(bf16, cfg, dev)
        assert loaded["embed"].is_cuda
        for k in ("qkv_w", "gate_up_w", "down_w", "post_norm"):
            got = loaded["layers"][k]
            assert got.is_cuda and got.dtype == torch.bfloat16
            assert torch.equal(got, params["layers"][k].to(torch.bfloat16)), k
        assert torch.equal(loaded["lm_head"],
                           params["lm_head"].to(torch.bfloat16))


@pytest.mark.parametrize("backend", ["fa_vattn_2mb", "fa_pod"])
def test_benchmark_main_test_on_the_card(dev, backend, tmp_path,
                                         monkeypatch):
    """``python -m vattention_tpu_torch.benchmark.main --test`` on the
    card: every request completes, and no CUDA graph is captured inside
    the timed loop (the runner's warm-up met every signature, the fused
    one on fa_pod among them)."""
    import argparse

    from vattention_tpu_torch.benchmark import benchmark_runner, main
    from vattention_tpu_torch.engine.base_llm_engine import BaseLLMEngine

    graphs = {}
    warmup = benchmark_runner.BenchmarkRunner._warmup
    cleanup = BaseLLMEngine.cleanup

    def spy_warmup(self):
        warmup(self)
        graphs["warm"] = set(self.engine.worker.model_runner.graphs)

    def spy_cleanup(self):
        graphs["end"] = set(self.worker.model_runner.graphs)
        cleanup(self)
    monkeypatch.setattr(benchmark_runner.BenchmarkRunner, "_warmup",
                        spy_warmup)
    monkeypatch.setattr(BaseLLMEngine, "cleanup", spy_cleanup)
    monkeypatch.chdir(tmp_path)
    summary = main.run_from_args(main.add_args(
        argparse.ArgumentParser()).parse_args(
            ["--test", "--attention-backend", backend]))
    assert summary["totals"]["completed_requests"] == 2
    assert graphs["end"] == graphs["warm"]
    assert any(sig[0] == 0 for sig in graphs["warm"])
    assert any(sig[1] for sig in graphs["warm"]) == (backend == "fa_pod")


def _tiny_tokens(engine):
    from vattention_tpu_torch import SamplingParams

    rng = np.random.default_rng(5)
    for i, n in enumerate([200, 37]):
        engine.add_request(
            prompt=None, prompt_token_ids=rng.integers(1, 2000, n).tolist(),
            sampling_params=SamplingParams(temperature=0.0, max_tokens=6,
                                           ignore_eos=True),
            seq_id=f"r{i}")
    out = {}
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
    return out


@pytest.mark.parametrize("pp,tp", [(1, 2), (2, 1)])
def test_gloo_ranks_on_one_card_match_the_one_rank_engine(dev, pp, tp):
    """Two ranks sharing one card (gloo: NCCL refuses two ranks on one
    device), started by ``LLMEngine`` from this process: the f32 tiny
    model's greedy tokens equal the one-rank engine's; every step runs
    eagerly (no graph) and kernels A, B and C launch on rank 0."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore
    from vattention_tpu_torch.ops.cache_append import ROPE_KV_APPEND
    from vattention_tpu_torch.ops.flash_prefill import PREFILL_ATTENTION

    kw = dict(model="tiny-llama-debug", dtype="float32",
              attention_backend="fa_vattn", scheduler_type="sarathi",
              max_model_len=512, max_batch_size=4, max_num_seqs=4,
              chunk_size=128, gpu_memory_utilization=0.4)
    MetricsStore._instance = None
    one = LLMEngine.from_engine_args(**kw)
    expect = _tiny_tokens(one)
    one.cleanup()
    MetricsStore._instance = None
    for k in (ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION):
        k.launches = 0
    engine = LLMEngine.from_engine_args(**kw, pipeline_parallel_size=pp,
                                        tensor_parallel_size=tp)
    assert engine.mesh.backend == "gloo" and engine.mesh.staged
    assert not engine.worker.model_runner.captures
    got = _tiny_tokens(engine)
    graphs = len(engine.worker.model_runner.graphs)
    engine.cleanup()
    MetricsStore._instance = None
    assert got == expect
    assert graphs == 0
    assert ROPE_KV_APPEND.launches > 0 and DECODE_ATTENTION.launches > 0
    assert PREFILL_ATTENTION.launches > 0


def test_backend_rule_on_this_host(dev):
    """nccl only when each rank owns a device: 1 rank per card here takes
    nccl, 2 ranks on one card gloo."""
    from vattention_tpu_torch.parallel.mesh import (pick_backend,
                                                    ranks_per_device)

    n = torch.cuda.device_count()
    assert pick_backend("cuda", ranks_per_device(n, "cuda")) == "nccl"
    assert pick_backend("cuda", ranks_per_device(n + 1, "cuda")) == "gloo"
    assert pick_backend("cuda", ranks_per_device(2 * n, "cuda")) == "gloo"
