"""Kernels G and H (single-run prefill) and the kernel-level harnesses, on
the CPU.

G's plain version against ``flash_prefill`` and H's against
``paged_flash_prefill`` (Pallas interpret mode, as tests/test_torch_paged.py
runs the JAX kernels), in float32 and bfloat16, on numpy-seeded inputs.
The JAX kernel resolves one row per kv tile from the extent table, so its
result is defined only for tile-aligned extents: the cross-package cases
use extents aligned to its 128-row tile, and the port's own cases hold G
to kernel B on the same rows with unaligned extents too.  Tolerances:
float32 within atol = rtol = 1e-4, as tests/test_torch_ops.py (online vs
full softmax, sums in other orders); bfloat16 within 2e-2, since each side
rounds its output to bf16 once (2^-8 of outputs of magnitude ~1) and the
JAX kernel also rounds P to bf16 before the PV product.

Then each harness of ``vattention_tpu_torch.microbenchmarks`` run with
``--cpu`` at tiny shapes prints its JAX twin's header and row keys, and
with ``--check`` holds each kernel's output to its plain version.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu.ops.flash_prefill import flash_prefill
from vattention_tpu.ops.paged_attention import paged_flash_prefill
from vattention_tpu_torch.microbenchmarks import (bench_pagesize,
                                                  bench_pod, bench_prefill,
                                                  kernel_sweep,
                                                  probe_pod_depth)
from vattention_tpu_torch.ops.flash_prefill import (
    prefill_attention, segment_prefill_attention, segment_rows)
from vattention_tpu_torch.ops.paged_attention import (
    paged_prefill_attention, paged_prefill_attention_single)
from vattention_tpu_torch.ops.utils import tile_rows_from_segments

ROOT = pathlib.Path(__file__).resolve().parents[1]
L, HKV, HQ, D = 2, 2, 4, 128
R = 2048          # arena / pool rows
S = 8             # extent table entries
KV_TILE = 128     # the JAX kernel's tile; cross-package extents align to it
POISON = 2 ** 30  # a block id far past the pool
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SM = D ** -0.5


def seg_tables(extents):
    """[(arena row, tokens), ...] -> seg_row [S], seg_cum [S+1] (int32)."""
    seg_row = np.zeros(S, np.int32)
    seg_cum = np.zeros(S + 1, np.int32)
    t = 0
    for j, (row, n) in enumerate(extents):
        seg_row[j], seg_cum[j] = row, t
        t += n
    seg_cum[len(extents):] = t
    return seg_row, seg_cum


def inputs(seed, dtype, Tq=256):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    q = rng.standard_normal((Tq, HQ, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return (rng, (jnp.asarray(q, jdt), jnp.asarray(cache, jdt)),
            (torch.from_numpy(q).to(tdt), torch.from_numpy(cache).to(tdt)))


def t32(x):
    return torch.from_numpy(np.asarray(x, np.int32))


def close(got, expect, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# three tile-aligned extents in no order, a chunk at q_start 450 and a
# kv_len of 700 (not a multiple of the tile); a fresh prompt's first chunk
# over one extent; the empty run
SEGMENT_CASES = {
    "three_extents": ([(512, 256), (1280, 128), (0, 384)], 450, 700),
    "first_chunk": ([(1024, 256)], 0, 256),
    "empty_run": ([(0, 128)], 0, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_prefill_matches_flash_prefill(case, dtype):
    extents, q_start, kv_len = SEGMENT_CASES[case]
    _, (jq, jcache), (q, cache) = inputs(1, dtype)
    seg_row, seg_cum = seg_tables(extents)
    expect = flash_prefill(
        jq, jcache, jnp.asarray(seg_row), jnp.asarray(seg_cum),
        jnp.asarray([q_start, kv_len, 1], jnp.int32), q_tile=128,
        kv_tile=KV_TILE, num_segments=S)
    got = segment_prefill_attention(q, cache, t32(seg_row), t32(seg_cum),
                                    t32([q_start, kv_len]), 1, sm_scale=SM)
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, expect, dtype)
    if kv_len == 0:
        assert not got.float().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_prefill_plain_in_slices_matches_flash_prefill(dtype):
    """512 query tokens: the plain version runs them in two slices of 256,
    the first over the 356 keys it can see."""
    extents, _, kv_len = SEGMENT_CASES["three_extents"]
    _, (jq, jcache), (q, cache) = inputs(6, dtype, Tq=512)
    seg_row, seg_cum = seg_tables(extents)
    expect = flash_prefill(
        jq, jcache, jnp.asarray(seg_row), jnp.asarray(seg_cum),
        jnp.asarray([100, kv_len, 0], jnp.int32), q_tile=128,
        kv_tile=KV_TILE, num_segments=S)
    got = segment_prefill_attention(q, cache, t32(seg_row), t32(seg_cum),
                                    t32([100, kv_len]), 0, sm_scale=SM)
    close(got, expect, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,q_start,kv_len", [(16, 450, 700), (128, 450, 700),
                                               (16, 0, 0)])
def test_paged_single_matches_paged_flash_prefill(bs, q_start, kv_len, dtype):
    """A shuffled table whose last block is partial, poisoned past it
    (neither side may read there); kv_len 0 gives zeros."""
    rng, (jq, jcache), (q, cache) = inputs(2, dtype)
    n = max(-(-kv_len // bs), 1)
    table = np.full(n + 3, POISON, np.int32)
    table[:n] = rng.permutation(R // bs)[:n]
    expect = paged_flash_prefill(
        jq, jcache, jnp.asarray(table),
        jnp.asarray([q_start, kv_len, 1], jnp.int32), q_tile=128,
        block_size=bs)
    got = paged_prefill_attention_single(q, cache, t32(table),
                                         t32([q_start, kv_len]), 1,
                                         block_size=bs, sm_scale=SM)
    close(got, expect, dtype)
    if kv_len == 0:
        assert not got.float().any()


@pytest.mark.parametrize("sub,extents", [
    (128, [(512, 256), (1280, 128), (0, 384)]),
    # unaligned: B's table at one row per entry names each position's row
    (1, [(517, 200), (1301, 77), (3, 500), (900, 1)]),
])
def test_segment_prefill_equals_b_on_the_same_rows(sub, extents):
    _, _, (q, cache) = inputs(3, "float32")
    seg_row, seg_cum = seg_tables(extents)
    kv_len = int(seg_cum[-1])
    qinfo = t32([kv_len - 200, kv_len])
    got = segment_prefill_attention(q, cache, t32(seg_row), t32(seg_cum),
                                    qinfo, 0, sm_scale=SM)
    rows = tile_rows_from_segments(seg_row[None], seg_cum[None], sub,
                                   -(-kv_len // sub))
    expect = prefill_attention(q, cache, t32([[0, 0], [0, 1]]),
                               qinfo.reshape(1, 2), t32(rows), 0, sub=sub,
                               pad_tile=128, sm_scale=SM)
    assert torch.equal(got, expect)


@pytest.mark.parametrize("bs", [16, 128])
def test_paged_single_equals_e_on_one_run(bs):
    rng, _, (q, cache) = inputs(4, "float32")
    table = np.full(R // bs, POISON, np.int32)
    table[:-(-700 // bs)] = rng.permutation(R // bs)[:-(-700 // bs)]
    qinfo = t32([450, 700])
    got = paged_prefill_attention_single(q, cache, t32(table), qinfo, 1,
                                         block_size=bs, sm_scale=SM)
    expect = paged_prefill_attention(q, cache, t32([[0, 0], [0, 1]]),
                                     qinfo.reshape(1, 2), t32(table[None]),
                                     1, block_size=bs, pad_tile=128,
                                     sm_scale=SM)
    assert torch.equal(got, expect)


@pytest.mark.parametrize("kernel", ["G", "H"])
def test_single_prefill_options_of_later_items_raise(kernel):
    """The sliding window, which G and H once refused (ROADMAP Queue 1 item
    12), now ported: G's and H's windowed plain versions against
    ``flash_prefill`` with the same ``window`` (the JAX paged kernel takes
    none), on three tile-aligned extents -- H through a block table naming
    the same rows -- at windows 1, 65 and 300, float32 within 1e-4, on the
    chunk's real rows (a padding row at least ``window`` past kv_len sees
    no key, which the JAX kernel leaves undefined)."""
    extents, q_start, kv_len = SEGMENT_CASES["three_extents"]
    _, (jq, jcache), (q, cache) = inputs(5, "float32")
    seg_row, seg_cum = seg_tables(extents)
    bs = 16
    rows = segment_rows(t32(seg_row), t32(seg_cum), kv_len).numpy()
    table = np.full(R // bs, POISON, np.int32)
    table[:-(-kv_len // bs)] = rows[::bs] // bs
    real = kv_len - q_start
    for window in (1, 65, 300):
        expect = flash_prefill(
            jq, jcache, jnp.asarray(seg_row), jnp.asarray(seg_cum),
            jnp.asarray([q_start, kv_len, 1], jnp.int32), q_tile=128,
            kv_tile=KV_TILE, num_segments=S, window=window)
        if kernel == "G":
            got = segment_prefill_attention(
                q, cache, t32(seg_row), t32(seg_cum), t32([q_start, kv_len]),
                1, sm_scale=SM, window=window)
        else:
            got = paged_prefill_attention_single(
                q, cache, t32(table), t32([q_start, kv_len]), 1,
                block_size=bs, sm_scale=SM, window=window)
        close(got[:real], np.asarray(expect)[:real], "float32")


# ---------------------------------------------------------------------- #
# the harnesses
# ---------------------------------------------------------------------- #
SWEEP_ARGS = ["--ctx", "256", "--batch", "2", "--kv-heads", "2",
              "--q-heads", "4", "--block-size", "128", "--iters", "1"]


def row_keys(lines):
    return [tuple(line.split(",")[:3]) for line in lines[1:]]


def test_kernel_sweep_prints_the_jax_twins_rows(capsys, tmp_path):
    jax_twin = subprocess.run(
        [sys.executable, "scripts/artifact/run_kernel_sweep.py", "--cpu",
         *SWEEP_ARGS], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache")})
    assert jax_twin.returncode == 0, jax_twin.stderr
    expect = jax_twin.stdout.strip().splitlines()
    assert kernel_sweep.main(["--cpu", *SWEEP_ARGS]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == expect[0] == kernel_sweep.HEADER
    assert row_keys(got) == row_keys(expect) == [
        ("prefill", "vattn_contig", "256"), ("prefill", "paged", "256"),
        ("decode", "vattn_contig", "256"), ("decode", "paged", "256")]
    for line in got[1:]:
        ms, gbps = line.split(",")[3:]
        assert float(ms) > 0 and float(gbps) >= 0


def check_lines(out):
    return [line.split(":")[0] for line in out.splitlines()
            if line.startswith("# check ")]


def test_kernel_sweep_check_holds_kernels_to_their_plain_versions(
        capsys, monkeypatch):
    assert kernel_sweep.main(["--cpu", "--check", *SWEEP_ARGS]) == 0
    out = capsys.readouterr().out
    assert check_lines(out) == [
        "# check G ctx 256", "# check H (bs 128) ctx 256",
        "# check C (sub 256) ctx 256", "# check C (sub 128) ctx 256"]
    assert out.count("max abs err 0.0 (row worst 0.00000)") == 4
    # a kernel off by 10% fails its check
    from vattention_tpu_torch.ops import flash_decode as fd
    real = fd.decode_attention
    monkeypatch.setattr(fd, "decode_attention",
                        lambda *a, **k: real(*a, **k) * 1.1)
    with pytest.raises(AssertionError, match="kernel_sweep C"):
        kernel_sweep.main(["--cpu", "--check", *SWEEP_ARGS])


def test_probe_pod_depth_check_holds_g_and_c_to_their_plain_versions(
        capsys, monkeypatch):
    argv = ["--cpu", "--check", "--depth", "512", "--prefill", "128",
            "--batch", "2", "--ctx", "128", "--hq", "4", "--hkv", "2",
            "--n-prefill", "2"]
    assert probe_pod_depth.main(argv) == 0
    out = capsys.readouterr().out
    assert check_lines(out) == ["# check G run 0 (128@512)",
                                "# check G run 1 (128@1024)",
                                "# check C (B=2x128)"]
    assert out.strip().splitlines()[-1] == "OK"
    from vattention_tpu_torch.ops import flash_decode as fd
    real = fd.decode_attention
    monkeypatch.setattr(fd, "decode_attention",
                        lambda *a, **k: real(*a, **k) * 1.1)
    with pytest.raises(AssertionError, match="probe_pod_depth C"):
        probe_pod_depth.main(argv)


def jax_twin_source(path):
    return (ROOT / path).read_text()


def test_bench_pagesize_prints_the_jax_twins_table(capsys):
    src = jax_twin_source("microbenchmarks/perf_pagesize/bench_pagesize.py")
    assert repr(bench_pagesize.HEADER).replace("'", '"') in src
    assert bench_pagesize.main(
        ["--cpu", "--ctx", "256", "--chunk", "128", "--batch", "2",
         "--kv-heads", "2", "--q-heads", "4", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == bench_pagesize.HEADER
    rows = [line.split("\t") for line in lines[1:]]
    # the JAX twin's block_tokens: page // (Hkv * D * 2)
    assert [(r[0], int(r[1])) for r in rows] == [
        ("64KB", 128), ("256KB", 512), ("2MB", 4096)]
    assert all(float(r[2]) > 0 and float(r[3]) > 0 for r in rows)


def test_bench_pod_prints_the_jax_twins_lines(capsys):
    src = jax_twin_source("microbenchmarks/bench_pod.py")
    assert 'us/layer-call' in src and "POD speedup over serial" in src
    assert bench_pod.main(
        ["--cpu", "--prefill", "128", "--history", "256", "--batch", "2",
         "--ctx", "128", "--hq", "4", "--hkv", "2", "--layers", "2",
         "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"    serial: +[\d.]+ us/layer-call", lines[0])
    assert re.fullmatch(r" pod_fused: +[\d.]+ us/layer-call", lines[1])
    assert re.fullmatch(r"POD speedup over serial: [+-][\d.]+%  \(prefill "
                        r"128@256, decode B=2x128\)", lines[2])


@pytest.mark.parametrize("n_prefill", [1, 3])
def test_probe_pod_depth_finds_f_equal_to_g_then_c(capsys, n_prefill):
    src = jax_twin_source("scripts/probe_pod_depth.py")
    assert "fused done" in src and "max|err| prefill=" in src
    assert probe_pod_depth.main(
        ["--cpu", "--depth", "512", "--prefill", "128", "--batch", "2",
         "--ctx", "128", "--hq", "4", "--hkv", "2", "--n-prefill",
         str(n_prefill)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(rf"depth=512 K={n_prefill} sched=\d+ "
                        r"\(pre \d+ dec \d+\)", lines[0])
    assert lines[1:] == ["fused done", "max|err| prefill=0.0 decode=0.0",
                         "OK"]


@pytest.mark.parametrize("harness", [kernel_sweep, bench_pagesize, bench_pod,
                                     probe_pod_depth, bench_prefill],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_harness_raises_without_a_gpu_unless_cpu(harness):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        harness.main([])


def test_bench_prefill_checks_and_times_each_kernel_on_the_cpu(capsys):
    """bench_prefill's plain versions at tiny shapes: B, G, E, H and F at
    (a)'s case over bf16, B over both 1-byte arenas, B and G at depth,
    each row with its bound."""
    assert bench_prefill.main(["--device", "cpu", "--calls", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("kernel,case,arena,")
    rows = [line.split(",") for line in lines[1:]]
    assert [(r[0], r[1], r[2]) for r in rows] == [
        *[(k, "a", "bf16") for k in "BGEHF"], ("B", "a", "e4m3"),
        ("B", "a", "int8"), ("B", "deep32k", "bf16"),
        ("G", "deep32k", "bf16"), ("B", "deep64k", "bf16"),
        ("G", "deep64k", "bf16")]
    assert all(float(r[4]) > 0 and r[5] in ("bytes", "operations")
               for r in rows)


def test_bench_prefill_bounds_are_the_per_call_tables():
    """At Yi's heads the bound of (a)'s chunk is PERF.md's 0.0326 ms of
    operations, and F's with the decode batch 0.0328 ms."""
    heads = bench_prefill.HEADS
    b_ms, by = bench_prefill.prefill_bound(512, 4096, heads, 2)
    assert by == "operations" and round(b_ms, 4) == 0.0326
    f_ms, by = bench_prefill.prefill_bound(512, 4096, heads, 2,
                                           bench_prefill.DEC_DEPTHS)
    assert by == "operations" and round(f_ms, 4) == 0.0328
