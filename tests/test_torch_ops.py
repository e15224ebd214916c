"""The port's plain kernel versions against the JAX package's Pallas kernels.

The same numpy-seeded inputs go through each TPU kernel (Pallas interpret
mode on the CPU, as tests/test_kernels.py runs them) and through the
PyTorch port's counterpart on CPU tensors, which takes the kernel's plain
version.  Tolerances: the appends and the relocation move bytes and must
match exactly; attention in float32 is held to atol = rtol = 1e-4, since
the Pallas kernels' online softmax and the plain versions' full softmax
sum in different orders.  Layers and host helpers are held the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu.ops import utils as jutils
from vattention_tpu.ops.arena_copy import apply_relocations
from vattention_tpu.ops.cache_append import (WINDOW, cache_append_run,
                                             cache_append_tokens)
from vattention_tpu.ops.flash_decode import flash_decode
from vattention_tpu.ops.flash_prefill import flash_prefill_multi
from vattention_tpu_torch.ops import utils as tutils
from vattention_tpu_torch.ops import arena_copy
from vattention_tpu_torch.ops.arena_copy import arena_relocate
from vattention_tpu_torch.ops.cache_append import kv_append
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import prefill_attention

L, HKV, HQ, D = 2, 2, 4, 128
R = 1024          # arena rows
S = 8             # extent budget
SUB = 128         # rows per table entry (the kv tile of the Pallas calls)
TOL = 1e-4


def make_cache(rng):
    return rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)


def seg_tables(extents_per_seq):
    """[[(row, ntokens), ...] per sequence] -> (seg_row [B, S],
    seg_cum [B, S+1])."""
    B = len(extents_per_seq)
    seg_row = np.zeros((B, S), np.int32)
    seg_cum = np.zeros((B, S + 1), np.int32)
    for b, extents in enumerate(extents_per_seq):
        t = 0
        for j, (row, n) in enumerate(extents):
            seg_row[b, j], seg_cum[b, j] = row, t
            t += n
        seg_cum[b, len(extents):] = t
    return seg_row, seg_cum


def t(x):
    return torch.from_numpy(np.array(x))


def test_kv_append_matches_cache_append_tokens():
    rng = np.random.default_rng(0)
    cache = make_cache(rng)
    T = 16
    k = rng.standard_normal((T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((T, HKV, D)).astype(np.float32)
    # decode rows, one per slot in distinct 32-row windows; -1 skips
    rows = np.full(T, -1, np.int32)
    rows[:8] = np.arange(40, 40 + 8 * 96, 96)
    rows[9:12] = [800, 1000, 7]
    expect = cache_append_tokens(jnp.asarray(cache), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(rows),
                                 jnp.ones(1, jnp.int32))
    got = t(cache)
    kv_append(got, t(k), t(v), t(rows), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_kv_append_matches_cache_append_run():
    rng = np.random.default_rng(1)
    cache = make_cache(rng)
    chunk = 100
    k = rng.standard_normal((chunk, HKV, D)).astype(np.float32)
    v = rng.standard_normal((chunk, HKV, D)).astype(np.float32)
    # two extent runs with unaligned boundaries: rows 37..96, 512..551
    rows = np.concatenate([np.arange(37, 97), np.arange(512, 552)])
    runinfo = np.zeros((8, 3), np.int32)
    runinfo[0] = (37, 0, 60)
    runinfo[1] = (512, 60, 40)
    pad = np.zeros((WINDOW, HKV, D), np.float32)
    expect = cache_append_run(
        jnp.asarray(cache), jnp.asarray(np.concatenate([pad, k, pad])),
        jnp.asarray(np.concatenate([pad, v, pad])), jnp.asarray(runinfo),
        jnp.zeros(1, jnp.int32), max_windows=chunk // WINDOW + 2)
    got = t(cache)
    kv_append(got, t(k), t(v), t(rows.astype(np.int32)), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("layer", [0, 1])
def test_prefill_attention_matches_flash_prefill_multi(layer):
    rng = np.random.default_rng(2 + layer)
    cache = make_cache(rng)
    q_tile = 128
    # run 0: two extents, chunked continuation; run 1: a short first chunk
    # (padded tile); run 2 = the empty run the tail tile maps to
    runs = [dict(extents=[(0, 256), (512, 256)], q_start=200, chunk=200),
            dict(extents=[(768, 128)], q_start=0, chunk=60),
            dict(extents=[], q_start=0, chunk=0)]
    seg_row, seg_cum = seg_tables([r["extents"] for r in runs])
    qinfo = np.array([[r["q_start"], r["q_start"] + r["chunk"]]
                      for r in runs], np.int32)
    qt_run = np.array([[0, 0], [0, 1], [1, 0], [2, 0]], np.int32)
    q = rng.standard_normal((4 * q_tile, HQ, D)).astype(np.float32)
    n_sub = R // SUB
    tile_rows = jutils.tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)
    expect = np.asarray(flash_prefill_multi(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(seg_row),
        jnp.asarray(seg_cum), jnp.asarray(qinfo), jnp.asarray(qt_run),
        jnp.asarray([layer], jnp.int32), jnp.asarray(tile_rows),
        q_tile=q_tile, kv_tile=SUB, num_segments=S, max_kv_tiles=n_sub))
    got = prefill_attention(t(q), t(cache), t(qt_run), t(qinfo),
                            t(tile_rows), layer, sub=SUB, pad_tile=q_tile,
                            sm_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    # the empty run's tile is zero in both
    assert not got[3 * q_tile:].any() and not expect[3 * q_tile:].any()


def test_decode_attention_matches_flash_decode():
    rng = np.random.default_rng(4)
    cache = make_cache(rng)
    extents = [[(0, 256)], [(256, 128), (640, 256)], [(384, 128)], [],
               [(896, 128)]]
    seqlens = np.array([250, 300, 1, 0, 128], np.int32)
    seg_row, seg_cum = seg_tables(extents)
    n_sub = 4
    tile_rows = jutils.tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)
    q = rng.standard_normal((5, HQ, D)).astype(np.float32)
    expect = np.asarray(flash_decode(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tile_rows),
        jnp.asarray(seqlens), jnp.ones(1, jnp.int32), kv_tile=SUB,
        max_kv_tiles=n_sub))
    got = decode_attention(t(q), t(cache), t(tile_rows), t(seqlens), 1,
                           sub=SUB, sm_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    assert not got[3].any() and np.isfinite(got).all()


def test_arena_relocate_matches_apply_relocations():
    rng = np.random.default_rng(5)
    cache = make_cache(rng)
    bt = 128
    # chained moves (block 3 leaves before block 1 takes its place), then
    # a padding entry the count excludes
    src = np.array([3, 1, 7, 0, 5], np.int32)
    dst = np.array([5, 3, 1, 7, 2], np.int32)
    expect = apply_relocations(jnp.asarray(cache), jnp.asarray(src),
                               jnp.asarray(dst), jnp.asarray([4], jnp.int32),
                               block_tokens=bt)
    got = t(cache)
    arena_relocate(got, t(src), t(dst), 4, bt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


# kernel D's batches (ops/arena_copy.relocation_batches): plans from the
# allocator at one and four kv heads (chip_smoke (a)'s strict plans at
# Yi's and falcon's arenas, (r dyn)'s geometry's dynamic plan), and hand-
# made ones: (src, dst, n_moves) with entries past n_moves as padding
HAND_PLANS = {
    "chained": ([3, 1, 7, 0, 5], [5, 3, 1, 7, 2], 4),
    "each reads the last's dst": ([0, 1, 2, 3, 4], [1, 2, 3, 4, 5], 5),
    "each frees the next's dst": ([3, 2, 1, 0], [4, 3, 2, 1], 4),
    "a block written twice": ([1, 2, 5, 4, 4], [4, 4, 6, 0, 7], 4),
    "a swap through a free block": ([0, 1, 9, 6], [9, 0, 1, 2], 3),
    "padded tail": ([2, 6, 0, 0, 0, 0], [6, 8, 0, 0, 0, 0], 2),
}
ALLOCATOR_PLANS = ("yi", "falcon", "rdyn")
MAX_BATCHES = (1, 4, 8, 16)
_plans = {}


def relocation_case(name):
    """(arena float32 numpy, src, dst, n_moves, block tokens, JAX
    apply_relocations' arena), computed once per plan."""
    from vattention_tpu_torch.microbenchmarks.bench_relocate import (
        GEOMETRIES, geometry)

    if name not in _plans:
        if name in HAND_PLANS:
            src, dst, n = HAND_PLANS[name]
            shape, bt = (L, 2, HKV, 10 * 32, 16), 32
        else:
            (l, two, _, rows, _), bt, src, dst = geometry(name, tiny=True)
            n = len(src)
            shape = (l, two, GEOMETRIES[name]["HKV"], rows, 16)
        cache = np.random.default_rng(7).standard_normal(shape).astype(
            np.float32)
        src_a, dst_a = np.array(src, np.int32), np.array(dst, np.int32)
        expect = np.asarray(apply_relocations(
            jnp.asarray(cache), jnp.asarray(src_a), jnp.asarray(dst_a),
            jnp.asarray([n], jnp.int32), block_tokens=bt))
        _plans[name] = (cache, src_a, dst_a, n, bt, expect)
    return _plans[name]


@pytest.mark.parametrize("max_batch", MAX_BATCHES)
@pytest.mark.parametrize("plan", [*ALLOCATOR_PLANS, *HAND_PLANS])
def test_relocation_batches_equal_apply_relocations(plan, max_batch):
    """Kernel D's cut of a plan, applied batch by batch in plain PyTorch
    (every load of a batch, then its stores in plan order), gives the JAX
    apply_relocations' arena bit for bit, as does arena_relocate on CPU
    tensors (the moves one by one)."""
    cache, src, dst, n, bt, expect = relocation_case(plan)
    got = t(cache)
    for start, end in arena_copy.relocation_batches(src.tolist(),
                                                    dst.tolist(), n,
                                                    max_batch):
        loads = [got[:, :, :, s * bt:(s + 1) * bt].clone()
                 for s in src[start:end]]
        for d, v in zip(dst[start:end], loads):
            got[:, :, :, d * bt:(d + 1) * bt] = v
    np.testing.assert_array_equal(got.numpy(), expect)
    one_by_one = t(cache)
    arena_relocate(one_by_one, t(src), t(dst), n, bt)
    np.testing.assert_array_equal(one_by_one.numpy(), expect)


@pytest.mark.parametrize("max_batch", MAX_BATCHES)
@pytest.mark.parametrize("plan", [*ALLOCATOR_PLANS, *HAND_PLANS])
def test_relocation_batches_cut_only_before_a_read_of_a_write(plan,
                                                              max_batch):
    """The batches tile the first n_moves moves in order; within one, no
    move reads a block an earlier move of it writes, and each ends full,
    at the plan's end, or before a move that would."""
    _, src, dst, n, _, _ = relocation_case(plan)
    batches = arena_copy.relocation_batches(src.tolist(), dst.tolist(), n,
                                            max_batch)
    assert [m for b in batches for m in range(*b)] == list(range(n))
    for start, end in batches:
        assert 0 < end - start <= max_batch
        for m in range(start + 1, end):
            assert src[m] not in dst[start:m]
        assert (end - start == max_batch or end == n
                or src[end] in dst[start:end])
    if plan == "each reads the last's dst":
        assert batches == [(m, m + 1) for m in range(n)]


# the arenas D relocates: Yi's (32 layers x 2 x 4 kv heads, 2048-row
# blocks), one kv head (falcon's, Yi's on a tp4 rank: 8192-row blocks),
# Yi's on a tp2 rank, and (r dyn)'s (16 layers x 2 x 4, 64-row blocks),
# as (slices, 16-byte vectors a block) of 128 bf16 lanes
RELOC_GEOMETRIES = {"yi": (256, 2048 * 16), "falcon": (64, 8192 * 16),
                    "tp2": (128, 4096 * 16), "tp4": (64, 8192 * 16),
                    "rdyn": (128, 64 * 16)}


def test_relocate_plan_limits_are_the_sources():
    import re
    from pathlib import Path

    text = (Path(arena_copy.__file__).resolve().parents[1] / "csrc"
            / "arena_relocate.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    assert (arena_copy.RELOC_THREADS, arena_copy.MAX_RELOC_VECS,
            arena_copy.BATCH_VECS, arena_copy.MAX_SLICES) == tuple(
        constant(n) for n in ("kRelocThreads", "kMaxRelocVecs", "kBatchVecs",
                              "kMaxSlices"))


@pytest.mark.parametrize("geo", list(RELOC_GEOMETRIES))
def test_relocate_plan_covers_every_vector_of_every_slice_once(geo):
    """On cards of 1 and 132 SMs, D's grid (chunks x slices) gives thread t
    of block (x, y) the offsets x * threads * vpt + i * threads + t (i <
    vpt) of slice y's blocks, as arena_relocate_kernel does: every vector
    of every slice is taken once, no chunk is left without work, and the
    plan keeps the source's limits (the 132-SM card several blocks an
    SM)."""
    slices, block_vecs = RELOC_GEOMETRIES[geo]
    for sms in (1, 132):
        p = arena_copy.relocate_plan(slices, block_vecs, sms)
        assert p.vpt in (1, 2, arena_copy.MAX_RELOC_VECS)
        assert p.threads % 32 == 0 and 0 < p.threads <= arena_copy.RELOC_THREADS
        assert 0 < p.batch and p.vpt * p.batch <= arena_copy.BATCH_VECS
        assert 0 < slices <= arena_copy.MAX_SLICES
        tile = p.threads * p.vpt
        assert tile * p.chunks >= block_vecs > tile * (p.chunks - 1)
        offsets = (np.arange(p.chunks)[:, None, None] * tile
                   + np.arange(p.vpt)[:, None] * p.threads
                   + np.arange(p.threads)).ravel()
        offsets = offsets[offsets < block_vecs]
        vectors = (np.arange(slices)[:, None] * block_vecs + offsets).ravel()
        assert np.array_equal(np.sort(vectors),
                              np.arange(slices * block_vecs))
        if sms == 132:
            assert slices * p.chunks >= 2 * sms


def test_relocate_plan_refuses_what_the_kernel_does_not_take():
    for slices, block_vecs in ((0, 1024), (arena_copy.MAX_SLICES + 1, 1024),
                               (64, 0)):
        with pytest.raises(ValueError):
            arena_copy.relocate_plan(slices, block_vecs, 132)


@pytest.mark.parametrize("sub,n_sub", [(64, 20), (128, 8), (256, 4)])
def test_host_helpers_match(sub, n_sub):
    seg_row, seg_cum = seg_tables([[(0, 256)], [(256, 128), (640, 256)],
                                   [], [(768, 256), (128, 128)]])
    np.testing.assert_array_equal(
        tutils.tile_rows_from_segments(seg_row, seg_cum, sub, n_sub),
        jutils.tile_rows_from_segments(seg_row, seg_cum, sub, n_sub))
    for bt in (64, 128, 170, 2048):
        assert tutils.select_kv_tile(bt, sub) == jutils.select_kv_tile(bt, sub)
    assert tutils.cdiv(1000, sub) == jutils.cdiv(1000, sub)
    assert tutils.round_up(1000, sub) == jutils.round_up(1000, sub)
    assert tutils.MASK_VALUE == jutils.MASK_VALUE


def test_attention_references_match():
    from vattention_tpu.ops import attention_ref as jref
    from vattention_tpu_torch.ops import attention_ref as tref

    rng = np.random.default_rng(6)
    q = rng.standard_normal((40, HQ, 64)).astype(np.float32)
    k = rng.standard_normal((90, HKV, 64)).astype(np.float32)
    v = rng.standard_normal((90, HKV, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tref.mha_reference(t(q), t(k), t(v), causal=True, q_start=50).numpy(),
        np.asarray(jref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      q_start=50)), atol=TOL, rtol=TOL)
    qd = rng.standard_normal((3, HQ, 64)).astype(np.float32)
    kc = rng.standard_normal((3, 90, HKV, 64)).astype(np.float32)
    vc = rng.standard_normal((3, 90, HKV, 64)).astype(np.float32)
    lens = np.array([90, 0, 7], np.int32)
    np.testing.assert_allclose(
        tref.decode_reference(t(qd), t(kc), t(vc), t(lens)).numpy(),
        np.asarray(jref.decode_reference(jnp.asarray(qd), jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(lens))),
        atol=TOL, rtol=TOL)


def test_layers_match():
    from vattention_tpu.model_executor.layers import activation as jact
    from vattention_tpu.model_executor.layers import layernorm as jln
    from vattention_tpu_torch.model_executor.layers import activation as tact
    from vattention_tpu_torch.model_executor.layers import layernorm as tln

    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 256)).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(
        tln.rms_norm(t(x), t(w), 1e-5).numpy(),
        np.asarray(jln.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tact.silu_and_mul(t(x)).numpy(),
        np.asarray(jact.silu_and_mul(jnp.asarray(x))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scaling", [
    None, {"type": "linear", "factor": 4.0},
    {"type": "dynamic", "factor": 2.0},
    {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 4096},
])
def test_rope_matches(scaling):
    from vattention_tpu.model_executor.layers.rotary_embedding import (
        get_rope as jrope)
    from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
        get_rope as trope)

    rng = np.random.default_rng(8)
    pos = np.array([0, 1, 5, 100, 4000, 8191], np.int32)
    q = rng.standard_normal((6, HQ, D)).astype(np.float32)
    k = rng.standard_normal((6, HKV, D)).astype(np.float32)
    jq, jk = jrope(D, D, 8192, 5e6, scaling)(jnp.asarray(pos),
                                             jnp.asarray(q), jnp.asarray(k))
    tq, tk = trope(D, D, 8192, 5e6, scaling)(t(pos), t(q), t(k))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4,
                               rtol=1e-4)


def test_sampler_greedy_and_packing_match():
    from vattention_tpu.model_executor.layers import sampler as js
    from vattention_tpu_torch.model_executor.layers import sampler as ts

    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 300)).astype(np.float32)
    temps = np.zeros(4, np.float32)
    top_p = np.ones(4, np.float32)
    top_k = np.full(4, -1, np.int32)
    jtok = np.asarray(js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_p),
        jnp.asarray(top_k), __import__("jax").random.PRNGKey(0)))
    ttok = ts.sample_tokens(t(logits), t(temps), t(top_p), t(top_k),
                            ts.sampler_mode(temps, top_p, top_k, 300)).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    tokens = np.array([3, -1, 299, 0], np.int32)
    jp = js.unpack_samples(js.pack_samples(jnp.asarray(logits),
                                           jnp.asarray(tokens), 2), 2)
    tp = ts.unpack_samples(ts.pack_samples(t(logits), t(tokens), 2).numpy(),
                           2)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    # a non-greedy draw with top-k 1 is the argmax, from any generator
    hot_t, hot_k = np.ones(4, np.float32), np.ones(4, np.int32)
    hot = ts.sample_tokens(t(logits), t(hot_t), t(top_p), t(hot_k),
                           ts.sampler_mode(hot_t, top_p, hot_k, 300),
                           torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(hot, jtok)
