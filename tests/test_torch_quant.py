"""Quantized KV (e4m3 and int8 arenas): the port against the JAX package.

The same numpy-seeded inputs go through the JAX package (its backend's
``_flush_fp8_subnormals`` / ``_quantize_int8`` and the Pallas kernels in
interpret mode, as tests/test_kernels.py runs them) and through the port's
plain versions on CPU tensors.

- Kernel A's plain version quantizes as JAX's backend then append kernels
  do, bit for bit, on |x| <= 448, at the flush cutoff's neighbours, at
  e4m3's rounding midpoints and at int8's half steps.
- The port's widening equals ``upcast_kv`` and ``astype`` on all 254
  finite e4m3 patterns.
- Each attention kernel's plain version on a 1-byte arena (written as
  kernel A writes it) matches its Pallas kernel, B and C with
  ``fp8_packed`` off and on: float32 q within atol = rtol = 1e-4, as
  tests/test_torch_ops.py (online vs full softmax); bfloat16 q within 2e-2
  and each output row within 2^-6 of its largest output
  (``timing.check_attention``).  An int8 arena's scores take
  ``sm_scale * kv_scale`` and its outputs are compared after the
  backend's ``* kv_scale``.
- The deliberate divergences from the JAX package are pinned: e4m3
  overflow saturates to +-448 (JAX: NaN past 464); no packed row
  permutation; no ``VATTN_FP8_*`` knobs.
"""

import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu.model_executor.attention.vattn_backend import (
    VattnAttentionBackend as JaxBackend)
from vattention_tpu.ops import utils as jutils
from vattention_tpu.ops.cache_append import (WINDOW, cache_append_run,
                                             cache_append_tokens)
from vattention_tpu.ops.flash_decode import flash_decode
from vattention_tpu.ops.flash_prefill import flash_prefill, flash_prefill_multi
from vattention_tpu.ops.paged_attention import (paged_flash_decode,
                                                paged_flash_prefill,
                                                paged_flash_prefill_multi)
from vattention_tpu.ops.pod_fused import build_pod_schedule, pod_fused_attention
from vattention_tpu_torch.microbenchmarks.timing import check_attention
from vattention_tpu_torch.ops import utils as tutils
from vattention_tpu_torch.ops.cache_append import kv_append
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import (prefill_attention,
                                                    segment_prefill_attention)
from vattention_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_prefill_attention,
    paged_prefill_attention_single)
from vattention_tpu_torch.ops.pod_fused import pod_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
L, HKV, HQ, D = 2, 2, 4, 128
R = 1024
S = 8
SUB = 128
STEP = 0.04          # the int8 step (KV_INT8_SCALE's default)
SM = D ** -0.5
ARENAS = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "int8": (torch.int8, jnp.int8)}
QDTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def t(x):
    return torch.from_numpy(np.array(x))


def seg_tables(extents_per_seq):
    B = len(extents_per_seq)
    seg_row = np.zeros((B, S), np.int32)
    seg_cum = np.zeros((B, S + 1), np.int32)
    for b, extents in enumerate(extents_per_seq):
        n = 0
        for j, (row, k) in enumerate(extents):
            seg_row[b, j], seg_cum[b, j] = row, n
            n += k
        seg_cum[b, len(extents):] = n
    return seg_row, seg_cum


def to_jax(x: torch.Tensor):
    """A port tensor as the JAX array of the same bits."""
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(x.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def bits(x):
    """The bytes of a port tensor or a JAX array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def quant_arena(rng, arena, shape=(L, 2, HKV, R, D)):
    """A seeded arena as kernel A writes it: N(0, 1) values flushed and
    rounded to e4m3, or quantized to int8 in steps of STEP."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return tutils.quantize_kv(x, ARENAS[arena][0], STEP)


def scales(arena):
    """(sm_scale, output scale) as the backends fold an int8 step."""
    return (SM * STEP, STEP) if arena == "int8" else (SM, 1.0)


def qs(rng, shape, qdtype):
    x = rng.standard_normal(shape).astype(np.float32)
    tq = torch.from_numpy(x).to(QDTYPES[qdtype][0])
    return tq, to_jax(tq)


def close(what, got, expect, qdtype, out_scale=1.0):
    """got (port, torch) against expect (JAX) after ``* out_scale``."""
    got = got.float() * out_scale
    expect = torch.from_numpy(np.array(expect, np.float32)) * out_scale
    if qdtype == "float32":
        torch.testing.assert_close(got, expect, atol=1e-4, rtol=1e-4)
    else:
        check_attention(what, got.reshape(got.shape[0], HQ, -1),
                        expect.reshape(expect.shape[0], HQ, -1))


CASES = [("fp8", "float32", False), ("fp8", "float32", True),
         ("fp8", "bfloat16", False), ("fp8", "bfloat16", True),
         ("int8", "float32", False), ("int8", "bfloat16", False)]


# ---------------------------------------------------------------------- #
# (i) kernel A's quantization
# ---------------------------------------------------------------------- #
def special_values(arena):
    """The edges of each quantization, as float32."""
    if arena == "fp8":
        cut = np.float32(15.0 * 2.0 ** -10)
        edge = [cut, np.nextafter(cut, np.float32(0)),
                np.nextafter(cut, np.float32(1)),
                # the cutoff's neighbours in bfloat16
                np.float32(1.8671875 * 2.0 ** -7),
                np.float32(1.8828125 * 2.0 ** -7), np.float32(0.015625),
                np.float32(2.0 ** -9), np.float32(448), np.float32(447),
                np.float32(440), np.float32(416), np.float32(0)]
        # midpoints between neighbouring e4m3 values (round half to even)
        vals = torch.arange(0, 0x7F, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float().numpy()
        mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
        base = np.concatenate([np.asarray(edge, np.float32), mids])
    else:
        n = np.arange(-130, 130, dtype=np.float32)
        half = ((n + 0.5) * np.float32(STEP)).astype(np.float32)
        base = np.concatenate([half, np.nextafter(half, np.float32(-1e9)),
                               np.nextafter(half, np.float32(1e9)),
                               np.float32([10.0, 127 * STEP, 128 * STEP])])
    return np.concatenate([base, -base])


def append_inputs(rng, T, arena, src):
    """k, v [T, HKV, D] of random values with the special values spread
    over them, in the source dtype (the same values on both sides)."""
    scale = 3.0 if arena == "fp8" else 2.0
    k = (rng.standard_normal((T, HKV, D)) * scale).astype(np.float32)
    v = (rng.standard_normal((T, HKV, D)) * scale).astype(np.float32)
    sp = special_values(arena)
    k.reshape(-1)[rng.permutation(k.size)[:sp.size]] = sp
    v.reshape(-1)[rng.permutation(v.size)[:sp.size]] = sp[::-1]
    tk = torch.from_numpy(k).to(QDTYPES[src][0])
    tv = torch.from_numpy(v).to(QDTYPES[src][0])
    return tk, tv


@pytest.mark.parametrize("path", ["tokens", "run"])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("arena", ["fp8", "int8"])
def test_kv_append_quantizes_as_jax(arena, src, path):
    rng = np.random.default_rng(30)
    cache = quant_arena(rng, arena)
    T = 16 if path == "tokens" else 100
    k, v = append_inputs(rng, T, arena, src)
    if path == "tokens":
        rows = np.full(T, -1, np.int32)
        rows[:8] = np.arange(40, 40 + 8 * 96, 96)
        rows[9:12] = [800, 1000, 7]
    else:
        rows = np.concatenate([np.arange(37, 97), np.arange(512, 552)]
                              ).astype(np.int32)
    if arena == "fp8":
        def jquant(x):
            return JaxBackend._flush_fp8_subnormals(x, jnp.float8_e4m3fn)
    else:
        def jquant(x):
            return JaxBackend._quantize_int8(
                SimpleNamespace(kv_scale=STEP), x)
    jk, jv = jquant(to_jax(k)), jquant(to_jax(v))
    if path == "tokens":
        expect = cache_append_tokens(to_jax(cache), jk, jv,
                                     jnp.asarray(rows),
                                     jnp.ones(1, jnp.int32))
    else:
        runinfo = np.zeros((8, 3), np.int32)
        runinfo[0] = (37, 0, 60)
        runinfo[1] = (512, 60, 40)
        pad = jnp.zeros((WINDOW, HKV, D), jk.dtype)
        expect = cache_append_run(
            to_jax(cache), jnp.concatenate([pad, jk, pad]),
            jnp.concatenate([pad, jv, pad]), jnp.asarray(runinfo),
            jnp.ones(1, jnp.int32), max_windows=T // WINDOW + 2)
    got = cache.clone()
    kv_append(got, k, v, t(rows), 1,
              kv_scale=STEP if arena == "int8" else None)
    np.testing.assert_array_equal(bits(got), bits(expect))


def test_kv_append_needs_a_step_for_int8_only():
    k = torch.zeros(1, HKV, D)
    rows = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_scale"):
        kv_append(torch.zeros(1, 2, HKV, 8, D, dtype=torch.int8), k, k,
                  rows, 0)
    with pytest.raises(ValueError, match="kv_scale"):
        kv_append(torch.zeros(1, 2, HKV, 8, D, dtype=torch.float8_e4m3fn),
                  k, k, rows, 0, kv_scale=STEP)


# ---------------------------------------------------------------------- #
# (ii) the widening
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_widening_is_exact_on_every_e4m3_pattern(qdtype):
    pats = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F],
                        dtype=torch.uint8)
    assert pats.numel() == 254
    x = pats.view(torch.float8_e4m3fn).reshape(2, 127)
    tdt, jdt = QDTYPES[qdtype]
    got = tutils.widen_kv(x, tdt).float().numpy()
    jx = to_jax(x)
    np.testing.assert_array_equal(
        got, np.asarray(jutils.upcast_kv(jx, jdt), np.float32))
    np.testing.assert_array_equal(got, np.asarray(jx.astype(jdt),
                                                  np.float32))
    # every pattern widens to a distinct value but +-0
    assert len(set(got.reshape(-1).tolist())) == 253


def test_widening_is_exact_on_every_int8_value():
    x = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    for tdt, jdt in QDTYPES.values():
        got = tutils.widen_kv(x, tdt).float().numpy()
        np.testing.assert_array_equal(got, np.arange(-128, 128))
        np.testing.assert_array_equal(
            got, np.asarray(to_jax(x).astype(jdt), np.float32))


# ---------------------------------------------------------------------- #
# (iii) each kernel module's plain version on 1-byte arenas
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arena,qdtype,packed", CASES)
def test_prefill_on_quantized_arena_matches_flash_prefill_multi(
        arena, qdtype, packed):
    """Kernel B: runs over two extents and one, then the empty run."""
    rng = np.random.default_rng(31)
    cache = quant_arena(rng, arena)
    runs = [([(0, 256), (512, 256)], 200, 200), ([(768, 128)], 0, 60),
            ([], 0, 0)]
    seg_row, seg_cum = seg_tables([r[0] for r in runs])
    qinfo = np.array([[q0, q0 + n] for _, q0, n in runs], np.int32)
    qt_run = np.array([[0, 0], [0, 1], [1, 0], [2, 0]], np.int32)
    q, jq = qs(rng, (4 * 128, HQ, D), qdtype)
    n_sub = R // SUB
    tile_rows = jutils.tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)
    sm, out_scale = scales(arena)
    expect = flash_prefill_multi(
        jq, to_jax(cache), jnp.asarray(seg_row), jnp.asarray(seg_cum),
        jnp.asarray(qinfo), jnp.asarray(qt_run), jnp.ones(1, jnp.int32),
        jnp.asarray(tile_rows), q_tile=128, kv_tile=SUB, num_segments=S,
        max_kv_tiles=n_sub, sm_scale=sm, fp8_packed=packed)
    got = prefill_attention(q, cache, t(qt_run), t(qinfo), t(tile_rows), 1,
                            sub=SUB, pad_tile=128, sm_scale=sm)
    assert got.dtype == q.dtype
    close("B", got, expect, qdtype, out_scale)
    assert not got[3 * 128:].float().any()


@pytest.mark.parametrize("arena,qdtype,packed", CASES)
def test_decode_on_quantized_arena_matches_flash_decode(arena, qdtype,
                                                        packed):
    """Kernel C: slots over one and two extents, depth 1, an idle slot."""
    rng = np.random.default_rng(32)
    cache = quant_arena(rng, arena)
    extents = [[(0, 256)], [(256, 128), (640, 256)], [(384, 128)], [],
               [(896, 128)]]
    seqlens = np.array([250, 300, 1, 0, 128], np.int32)
    seg_row, seg_cum = seg_tables(extents)
    n_sub = 4
    tile_rows = jutils.tile_rows_from_segments(seg_row, seg_cum, SUB, n_sub)
    q, jq = qs(rng, (5, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    expect = flash_decode(jq, to_jax(cache), jnp.asarray(tile_rows),
                          jnp.asarray(seqlens), jnp.ones(1, jnp.int32),
                          kv_tile=SUB, max_kv_tiles=n_sub, sm_scale=sm,
                          fp8_packed=packed)
    got = decode_attention(q, cache, t(tile_rows), t(seqlens), 1, sub=SUB,
                           sm_scale=sm)
    close("C", got, expect, qdtype, out_scale)
    assert not got[3].float().any()


QUANT = [(a, q) for a in ARENAS for q in QDTYPES]


def paged_tables(rng, depths, bs, width):
    perm = rng.permutation(R // bs)
    tables = np.zeros((len(depths), width), np.int32)
    used = 0
    for r, n in enumerate(depths):
        k = -(-n // bs)
        tables[r, :k] = perm[used:used + k]
        used += k
    return tables


@pytest.mark.parametrize("arena,qdtype", QUANT)
def test_paged_prefill_on_quantized_pool_matches_jax(arena, qdtype):
    """Kernel E over 64-token blocks in no order."""
    rng = np.random.default_rng(33)
    cache = quant_arena(rng, arena)
    bs = 64
    runs = [(200, 400), (0, 60), (0, 0)]            # (q_start, kv_len)
    tables = paged_tables(rng, [n for _, n in runs], bs, R // bs)
    qinfo = np.array(runs, np.int32)
    qt_run = np.array([[0, 0], [0, 1], [1, 0], [2, 0]], np.int32)
    q, jq = qs(rng, (4 * 128, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    expect = paged_flash_prefill_multi(
        jq, to_jax(cache), jnp.asarray(tables), jnp.asarray(qinfo),
        jnp.asarray(qt_run), jnp.ones(1, jnp.int32), q_tile=128,
        block_size=bs, max_kv_tiles=R // bs, sm_scale=sm)
    got = paged_prefill_attention(q, cache, t(qt_run), t(qinfo), t(tables),
                                  1, block_size=bs, pad_tile=128,
                                  sm_scale=sm)
    expect = np.asarray(expect, np.float32)
    for lo, hi in ((0, 200), (256, 316)):
        close("E", got[lo:hi], expect[lo:hi], qdtype, out_scale)


@pytest.mark.parametrize("arena,qdtype", QUANT)
def test_paged_decode_on_quantized_pool_matches_jax(arena, qdtype):
    """Kernel C over 64-token block tables."""
    rng = np.random.default_rng(34)
    cache = quant_arena(rng, arena)
    bs = 64
    seqlens = np.array([0, 1, 250, 513, 64], np.int32)
    tables = paged_tables(rng, seqlens.tolist(), bs, 10)
    q, jq = qs(rng, (5, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    expect = paged_flash_decode(jq, to_jax(cache), jnp.asarray(tables),
                                jnp.asarray(seqlens), jnp.zeros(1, jnp.int32),
                                block_size=bs, sm_scale=sm)
    got = paged_decode_attention(q, cache, t(tables), t(seqlens), 0,
                                 block_size=bs, sm_scale=sm)
    close("paged C", got, expect, qdtype, out_scale)


@pytest.mark.parametrize("arena,qdtype", QUANT)
def test_pod_on_quantized_arena_matches_pod_fused_attention(arena, qdtype):
    """Kernel F: one run of 128 at depth 640 and 3 slots, one idle."""
    rng = np.random.default_rng(35)
    cache = quant_arena(rng, arena)
    pre = [[(0, 256), (512, 384)]]
    dec = [[(256, 256)], [], [(768, 256)]]   # aligned to the JAX kv tile
    seqlens = np.array([200, 0, 100], np.int32)
    qinfo = np.array([[512, 640]], np.int32)
    pre_row, pre_cum = seg_tables(pre)
    dec_row, dec_cum = seg_tables(dec)
    qp, jqp = qs(rng, (128, HQ, D), qdtype)
    qd, jqd = qs(rng, (3, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    sched = build_pod_schedule([128], 128, 256, qinfo, seqlens)
    op, od = pod_fused_attention(
        jqp, jqd, to_jax(cache), jnp.asarray(sched), jnp.asarray(pre_row),
        jnp.asarray(pre_cum), jnp.asarray(qinfo), jnp.ones(1, jnp.int32),
        jnp.asarray(dec_row), jnp.asarray(dec_cum), jnp.asarray(seqlens),
        q_tile=128, kv_tile=256, num_segments=S, sm_scale=sm)
    n_sub = R // SUB
    got_p, got_d = pod_attention(
        qp, qd, cache, t([[0, 0]]).int(), t(qinfo),
        t(jutils.tile_rows_from_segments(pre_row, pre_cum, SUB, n_sub)),
        t(jutils.tile_rows_from_segments(dec_row, dec_cum, SUB, n_sub)),
        t(seqlens), 1, sub=SUB, pad_tile=128, sm_scale=sm)
    close("F prefill", got_p, op, qdtype, out_scale)
    close("F decode", got_d, od, qdtype, out_scale)
    assert not got_d[1].float().any()


@pytest.mark.parametrize("arena,qdtype", QUANT)
def test_segment_prefill_on_quantized_arena_matches_flash_prefill(arena,
                                                                  qdtype):
    """Kernel G over three tile-aligned extents in no order."""
    rng = np.random.default_rng(36)
    cache = quant_arena(rng, arena)
    seg_row, seg_cum = seg_tables([[(512, 256), (128, 128), (768, 256)]])
    q, jq = qs(rng, (256, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    expect = flash_prefill(jq, to_jax(cache), jnp.asarray(seg_row[0]),
                           jnp.asarray(seg_cum[0]),
                           jnp.asarray([350, 600, 1], jnp.int32), q_tile=128,
                           kv_tile=SUB, num_segments=S, sm_scale=sm)
    got = segment_prefill_attention(q, cache, t(seg_row[0]), t(seg_cum[0]),
                                    t(np.int32([350, 600])), 1, sm_scale=sm)
    close("G", got, expect, qdtype, out_scale)


@pytest.mark.parametrize("arena,qdtype", QUANT)
def test_paged_single_on_quantized_pool_matches_paged_flash_prefill(
        arena, qdtype):
    """Kernel H over a shuffled table whose last block is partial."""
    rng = np.random.default_rng(37)
    cache = quant_arena(rng, arena)
    bs = 64
    table = paged_tables(rng, [600], bs, 12)[0]
    q, jq = qs(rng, (256, HQ, D), qdtype)
    sm, out_scale = scales(arena)
    expect = paged_flash_prefill(jq, to_jax(cache), jnp.asarray(table),
                                 jnp.asarray([350, 600, 1], jnp.int32),
                                 q_tile=128, block_size=bs, sm_scale=sm)
    got = paged_prefill_attention_single(q, cache, t(table),
                                         t(np.int32([350, 600])), 1,
                                         block_size=bs, sm_scale=sm)
    close("H", got, expect, qdtype, out_scale)


# ---------------------------------------------------------------------- #
# the deliberate divergences
# ---------------------------------------------------------------------- #
def test_fp8_overflow_saturates_where_jax_gives_nan():
    x = np.float32([500.0, -1000.0, 464.0, 448.0])
    got = tutils.flush_fp8_subnormals(torch.from_numpy(x)).float()
    assert got.tolist() == [448.0, -448.0, 448.0, 448.0]
    jax_got = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn),
                         np.float32)
    assert np.isnan(jax_got[:2]).all()
    assert jax_got[2:].tolist() == [448.0, 448.0]


def test_widening_keeps_row_order_where_jax_packs():
    """The JAX package's packed widening returns a tile's rows permuted
    (``packed_kv_pos`` maps them back inside its kernels, which the
    ``fp8_packed=True`` cases above run); the port widens in place, row
    for row, and has no such map."""
    pos = np.asarray(jutils.packed_kv_pos(jnp.arange(64), 64))
    assert sorted(pos.tolist()) == list(range(64))
    assert not np.array_equal(pos, np.arange(64))
    rng = np.random.default_rng(38)
    x = quant_arena(rng, "fp8", (64, D))
    wide = tutils.widen_kv(x, torch.float32)
    for i in range(64):
        assert torch.equal(wide[i], x[i].float())
    assert not hasattr(tutils, "packed_kv_pos")


def test_no_fp8_knobs(monkeypatch):
    """``VATTN_FP8_PACKED`` and ``VATTN_FP8_EXACT`` steer the JAX kernels'
    widening; the port reads neither and its result does not move."""
    rng = np.random.default_rng(39)
    cache = quant_arena(rng, "fp8")
    q = torch.from_numpy(rng.standard_normal((3, HQ, D)).astype(np.float32))
    rows = t(np.arange(4, dtype=np.int32)[None].repeat(3, 0) * SUB)
    lens = t(np.int32([500, 17, 300]))
    base = decode_attention(q, cache, rows, lens, 0, sub=SUB, sm_scale=SM)
    for packed, exact in (("0", "1"), ("1", "0")):
        monkeypatch.setenv("VATTN_FP8_PACKED", packed)
        monkeypatch.setenv("VATTN_FP8_EXACT", exact)
        assert jutils.fp8_packed_enabled(jnp.float8_e4m3fn) == (packed == "1")
        assert torch.equal(decode_attention(q, cache, rows, lens, 0,
                                            sub=SUB, sm_scale=SM), base)
    sources = (ROOT / "vattention_tpu_torch").rglob("*.py")
    assert not any("VATTN_FP8" in p.read_text() for p in sources)


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
def test_kernel_sweep_on_quantized_arenas(capsys, kv_dtype):
    """``kernel_sweep --kv-dtype`` runs G, H and C over a 1-byte arena and,
    with ``--check``, holds each against its plain version; its gbps count
    one byte per K/V element."""
    from vattention_tpu_torch.microbenchmarks import kernel_sweep

    args = ["--cpu", "--check", "--ctx", "256", "--batch", "2",
            "--kv-heads", "2", "--q-heads", "4", "--block-size", "128",
            "--iters", "1"]
    rows = kernel_sweep.sweep(kernel_sweep.parser().parse_args(
        args + ["--kv-dtype", kv_dtype]))
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("# check ")] == [
        "# check G ctx 256", "# check H (bs 128) ctx 256",
        "# check C (sub 256) ctx 256", "# check C (sub 128) ctx 256"]
    decode = [r for r in rows if r[0] == "decode"]
    for _, _, ctx, ms, gbps in decode:
        # batch 2 x ctx x 2 heads x D, K and V, 1 byte each
        assert gbps == pytest.approx(2 * ctx * 2 * D * 2 / (ms * 1e-3) / 1e9)
