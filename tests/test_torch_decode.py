"""Kernel C (decode attention) on the CPU: the port against the JAX
``flash_decode`` at tile and split edges, and a plain Python twin of the
split plan that kernel C's body (``csrc/decode_attention.cuh``, shared with
kernel F) computes on the device.

The same numpy-seeded inputs go through the Pallas kernel (interpret mode)
and through the port's ``decode_attention`` on CPU tensors, which takes the
plain version; float32, atol = rtol = 1e-4 (the Pallas kernel's online
softmax and the plain full softmax sum in different orders).  Idle slots
must be exactly zero.  The plan's twin is held to what the kernel relies
on: every live (slot, head, position) in exactly one range, in order; no
range across slots; no range for an idle slot; at most grid + B * Hkv
ranges; nothing of the table's depth among its inputs.  Merging per-range
partials in split order, as the kernel does, is held against the plain
version at 1e-5 (float64 arithmetic against a float32 softmax).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu.ops.flash_decode import flash_decode
from vattention_tpu_torch.ops.flash_decode import (DECODE_TILE, MAX_SLOTS,
                                                   MIN_SPLIT_TILES,
                                                   decode_attention,
                                                   decode_attention_plain)

L, HKV, HQ, D = 2, 2, 4, 128
R = 2048          # arena rows
SUB = 128         # rows per table entry (the kv tile of the Pallas call)
TOL = 1e-4
EDGE_DEPTHS = [1, 63, 64, 65, 255, 256, 257]
CUH = (Path(__file__).resolve().parents[1] / "vattention_tpu_torch" / "csrc"
       / "decode_attention.cuh")


def cdiv(a, b):
    return -(-a // b)


def first_tile(n, window):
    """Twin of ``first_tile``: the first tile a slot at depth n walks."""
    return (n - window) // DECODE_TILE if window and n > window else 0


def live_tiles(n, window):
    """Twin of ``live_tiles``: the tiles a slot at depth n walks."""
    return cdiv(n, DECODE_TILE) - first_tile(n, window) if n > 0 else 0


def split_plan(seqlens, hkv, grid, window=None,
               min_tiles=MIN_SPLIT_TILES):
    """Twin of ``make_plan``: every range (b, h, i, n, first tile, end
    tile) in range order, and c, a split's least tiles (at least
    ``min_tiles``, the kernel's argument, MIN_SPLIT_TILES by default)."""
    tiles = [live_tiles(n, window) for n in seqlens]
    work = hkv * sum(tiles)
    live = hkv * sum(t > 0 for t in tiles)
    share = max(grid - live, grid // 2, 1)
    per = max(min_tiles, cdiv(work, share))
    ranges = []
    for b, t in enumerate(tiles):
        n = cdiv(t, per)
        f = first_tile(seqlens[b], window)
        for h in range(hkv):
            ranges += [(b, h, i, n, f + i * t // n, f + (i + 1) * t // n)
                       for i in range(n)]
    return ranges, per


def find_range(r, seqlens, hkv, grid, window=None,
               min_tiles=MIN_SPLIT_TILES):
    """Twin of ``find_range``: range r from the plan's prefix ``cum`` by
    the kernel's binary search."""
    ranges, per = split_plan(seqlens, hkv, grid, window, min_tiles)
    cum = np.cumsum([0] + [cdiv(live_tiles(n, window), per) * hkv
                           for n in seqlens]).tolist()
    lo, hi = 0, len(seqlens) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cum[mid] <= r:
            lo = mid
        else:
            hi = mid - 1
    n = (cum[lo + 1] - cum[lo]) // hkv
    h, i = divmod(r - cum[lo], n)
    t = live_tiles(seqlens[lo], window)
    f = first_tile(seqlens[lo], window)
    return (lo, h, i, n, f + i * t // n, f + (i + 1) * t // n)


def random_batches():
    """Seeded batches: serving-like, mostly idle, one deep slot, a
    large batch of short slots, every slot idle."""
    rng = np.random.default_rng(11)
    return [
        [0, 1, 17, 512, 1000, 2048, 3000, 4096],
        [0, 0, 0, 5, 0, 0, 0, 0],
        [32768, 1, 0, 300],
        rng.integers(0, 300, 256).tolist(),
        rng.integers(1, 40000, 16).tolist(),
        EDGE_DEPTHS + [0] * 3,
        [0] * 8,
    ]


def make_inputs(rng, depths, n_sub):
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    tile_rows = np.stack([rng.permutation(R // SUB)[:n_sub] * SUB
                          for _ in depths]).astype(np.int32)
    q = rng.standard_normal((len(depths), HQ, D)).astype(np.float32)
    return q, cache, tile_rows, np.asarray(depths, np.int32)


@pytest.mark.parametrize("depth", EDGE_DEPTHS)
def test_decode_attention_matches_flash_decode_at_edges(depth):
    """Slots at ``depth`` (a tile or split edge of kernel C), an idle slot,
    and a 5-position slot whose table is 16 entries (2048 positions)
    deep; float32, 1e-4; the idle slot exactly zero."""
    rng = np.random.default_rng(depth)
    n_sub = R // SUB
    q, cache, tile_rows, seqlens = make_inputs(rng, [depth, 0, 5, depth],
                                               n_sub)
    expect = np.asarray(flash_decode(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tile_rows),
        jnp.asarray(seqlens), jnp.ones(1, jnp.int32), kv_tile=SUB,
        max_kv_tiles=n_sub))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(cache),
                           torch.from_numpy(tile_rows),
                           torch.from_numpy(seqlens), 1, sub=SUB,
                           sm_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    assert not got[1].any() and np.isfinite(got).all()


@pytest.mark.parametrize("grid", [264, 2, 1])
@pytest.mark.parametrize("batch", range(len(random_batches())))
def test_split_plan_covers_each_live_position_once(batch, grid):
    """Each live (slot, head) is covered by its splits' tile ranges
    exactly once, in split order, up to the slot's live depth and no
    further; idle slots get no range; the kernel's lookup by binary search
    finds every range; there are at most grid + B * Hkv ranges, and at most
    grid while live (slot, head) pairs are at most half the grid."""
    seqlens = random_batches()[batch]
    hkv = 4
    ranges, per = split_plan(seqlens, hkv, grid)
    assert per >= MIN_SPLIT_TILES
    for b, n in enumerate(seqlens):
        t = cdiv(n, DECODE_TILE) if n > 0 else 0
        for h in range(hkv):
            mine = [r for r in ranges if r[:2] == (b, h)]
            if t == 0:
                assert mine == []
                continue
            assert [r[2] for r in mine] == list(range(len(mine)))
            assert mine[0][4] == 0 and mine[-1][5] == t
            for prev, nxt in zip(mine, mine[1:]):
                assert prev[5] == nxt[4]
            # every range holds a position below the slot's depth, and only
            # the last may hold positions past it (masked in the kernel)
            assert all(lo < hi and lo * DECODE_TILE < n
                       for *_, lo, hi in mine)
            assert all(hi * DECODE_TILE <= n for *_, hi in mine[:-1])
    live = hkv * sum(n > 0 for n in seqlens)
    assert len(ranges) <= grid + len(seqlens) * hkv
    if live <= grid // 2:
        assert len(ranges) <= grid
    for r in range(len(ranges)):
        assert find_range(r, seqlens, hkv, grid) == ranges[r]


@pytest.mark.parametrize("min_tiles", [1, 2, 16])
@pytest.mark.parametrize("grid", [132, 264, 924])
@pytest.mark.parametrize("batch", [0, 2, 4])
def test_split_plan_at_other_least_splits(batch, grid, min_tiles):
    """The plan points ``bench_decode_kernel`` sweeps (a split's least
    tiles and the grid, ``decode_attention``'s ``min_split_tiles`` and
    ``blocks_per_sm``): each live (slot, head) still covered once, in
    order, to its depth, in cdiv(tiles, c) splits for c >= ``min_tiles``;
    at most grid + B * Hkv ranges, and the lookup finds each.
    At the defaults the plan is the one above."""
    seqlens = random_batches()[batch]
    hkv = 4
    ranges, per = split_plan(seqlens, hkv, grid, min_tiles=min_tiles)
    assert per >= min_tiles
    for b, n in enumerate(seqlens):
        t = cdiv(n, DECODE_TILE) if n > 0 else 0
        mine = [r for r in ranges if r[:2] == (b, 0)]
        assert (mine[0][4], mine[-1][5]) == (0, t) if t else mine == []
        assert len(mine) == cdiv(t, per)
        for prev, nxt in zip(mine, mine[1:]):
            assert prev[5] == nxt[4]
    assert len(ranges) <= grid + len(seqlens) * hkv
    for r in range(len(ranges)):
        assert find_range(r, seqlens, hkv, grid,
                          min_tiles=min_tiles) == ranges[r]
    assert split_plan(seqlens, hkv, grid) == split_plan(
        seqlens, hkv, grid, min_tiles=MIN_SPLIT_TILES)


def test_split_plan_reads_no_table():
    """The plan's inputs are the depths, the kv heads and the grid: the
    kernel's ``make_plan`` and ``find_range`` take no row table, and
    kernel C's launch passes a grid that does not come from one."""
    src = CUH.read_text()
    for fn in ("make_plan", "find_range"):
        sig = re.search(rf"{fn}\(([^)]*)\)", src).group(1)
        assert "tile_rows" not in sig and "n_sub" not in sig, sig
    wrapper = (CUH.parent.parent / "ops" / "flash_decode.py").read_text()
    launch = wrapper[wrapper.index("grid = decode_grid("):]
    assert "tile_rows" not in launch.splitlines()[0]


def test_split_plan_constants_match_the_kernel():
    """The twin's tile, least split and slot limit are the kernel's."""
    src = CUH.read_text()
    for name, value in (("kTile", DECODE_TILE), ("kMinTiles",
                                                 MIN_SPLIT_TILES),
                        ("kMaxSlots", MAX_SLOTS)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         src).group(1) == str(value)


@pytest.mark.parametrize("grid", [264, 3])
def test_split_partials_merge_to_the_plain_version(grid):
    """Each range's unnormalised (max, sum, output) over its positions,
    merged in split order per (slot, head) as the kernel's last split
    does, equals the plain version within 1e-5 (float64 against float32);
    idle slots stay zero."""
    rng = np.random.default_rng(3)
    depths = [0, 1, 200, 700, 65, 0]
    n_sub = R // SUB
    q, cache, tile_rows, seqlens = make_inputs(rng, depths, n_sub)
    G = HQ // HKV
    sm = D ** -0.5
    out = np.zeros_like(q, dtype=np.float64)
    parts = {}
    for b, h, i, n, lo, hi in split_plan(depths, HKV, grid)[0]:
        pos = np.arange(lo * DECODE_TILE, min(hi * DECODE_TILE, depths[b]))
        rows = tile_rows[b][pos // SUB] + pos % SUB
        k = cache[1, 0, h, rows].astype(np.float64)
        v = cache[1, 1, h, rows].astype(np.float64)
        s = q[b, h * G:(h + 1) * G].astype(np.float64) @ k.T * sm
        m = s.max(1)
        p = np.exp(s - m[:, None])
        parts.setdefault((b, h), []).append((m, p.sum(1), p @ v))
    for (b, h), ps in parts.items():
        mx = np.max([m for m, _, _ in ps], 0)
        lsum = sum(l * np.exp(m - mx) for m, l, _ in ps)
        osum = sum(o * np.exp(m - mx)[:, None] for m, _, o in ps)
        out[b, h * G:(h + 1) * G] = osum / lsum[:, None]
    expect = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(cache),
        torch.from_numpy(tile_rows), torch.from_numpy(seqlens), 1, sub=SUB,
        sm_scale=sm).numpy()
    np.testing.assert_allclose(out, expect, atol=1e-5, rtol=1e-5)
    assert not out[0].any() and not out[5].any()


@pytest.mark.parametrize("window", [1, 63, 64, 65, 4096])
@pytest.mark.parametrize("grid", [264, 3])
@pytest.mark.parametrize("batch", range(len(random_batches())))
def test_windowed_split_plan_covers_the_window_once(batch, grid, window):
    """Under a sliding window each live (slot, head)'s ranges cover the
    tiles from the one holding ``depth - window`` to the slot's last, once
    and in order, so every attended position lies in exactly one range
    and only the first tile holds positions below the window (masked in
    the kernel); the plan is sized by the window: no more tiles than
    cdiv(window, 64) + 1 per slot; the kernel's lookup finds every
    range."""
    seqlens = random_batches()[batch]
    hkv = 4
    ranges, per = split_plan(seqlens, hkv, grid, window)
    assert per >= MIN_SPLIT_TILES
    for b, n in enumerate(seqlens):
        mine = [r for r in ranges if r[:2] == (b, 0)]
        if n <= 0:
            assert mine == []
            continue
        lo = max(0, n - window)
        assert mine[0][4] == lo // DECODE_TILE
        assert mine[-1][5] == cdiv(n, DECODE_TILE)
        assert mine[-1][5] - mine[0][4] <= cdiv(window, DECODE_TILE) + 1
        for prev, nxt in zip(mine, mine[1:]):
            assert prev[5] == nxt[4]
        assert all(lo_t < hi_t for *_, lo_t, hi_t in mine)
    assert len(ranges) <= grid + len(seqlens) * hkv
    for r in range(len(ranges)):
        assert find_range(r, seqlens, hkv, grid, window) == ranges[r]


@pytest.mark.parametrize("window", [1, 65, 300])
def test_windowed_split_partials_merge_to_the_plain_version(window):
    """The windowed plan's per-range partials over the positions in [max(0,
    depth - window), depth) merge, in split order, to the windowed plain
    version within 1e-5."""
    rng = np.random.default_rng(4)
    depths = [0, 1, 200, 700, 65, 1900]
    q, cache, tile_rows, seqlens = make_inputs(rng, depths, R // SUB)
    G = HQ // HKV
    sm = D ** -0.5
    out = np.zeros_like(q, dtype=np.float64)
    parts = {}
    for b, h, i, n, lo, hi in split_plan(depths, HKV, 3, window)[0]:
        pos = np.arange(max(lo * DECODE_TILE, depths[b] - window),
                        min(hi * DECODE_TILE, depths[b]))
        rows = tile_rows[b][pos // SUB] + pos % SUB
        k = cache[1, 0, h, rows].astype(np.float64)
        v = cache[1, 1, h, rows].astype(np.float64)
        s = q[b, h * G:(h + 1) * G].astype(np.float64) @ k.T * sm
        m = s.max(1)
        p = np.exp(s - m[:, None])
        parts.setdefault((b, h), []).append((m, p.sum(1), p @ v))
    for (b, h), ps in parts.items():
        mx = np.max([m for m, _, _ in ps], 0)
        lsum = sum(l * np.exp(m - mx) for m, l, _ in ps)
        osum = sum(o * np.exp(m - mx)[:, None] for m, _, o in ps)
        out[b, h * G:(h + 1) * G] = osum / lsum[:, None]
    expect = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(cache),
        torch.from_numpy(tile_rows), torch.from_numpy(seqlens), 1, sub=SUB,
        sm_scale=sm, window=window).numpy()
    np.testing.assert_allclose(out, expect, atol=1e-5, rtol=1e-5)
    assert not out[0].any()
