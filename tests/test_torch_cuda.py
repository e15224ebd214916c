"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a); on a machine
without one they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -p no:xdist -q

Tolerances: kv_append and arena_relocate move bytes and must match
exactly; the attention kernels sum in another order than the plain
versions' full softmax, so float32 is held to 1e-4 and bfloat16 outputs
(rounded once) to 2e-2.
"""

import numpy as np
import pytest
import torch

from vattention_tpu_torch.ops.arena_copy import (arena_relocate,
                                                 arena_relocate_plain)
from vattention_tpu_torch.ops.cache_append import kv_append, kv_append_plain
from vattention_tpu_torch.ops.flash_decode import (decode_attention,
                                                   decode_attention_plain)
from vattention_tpu_torch.ops.flash_prefill import (prefill_attention,
                                                    prefill_attention_plain)
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
