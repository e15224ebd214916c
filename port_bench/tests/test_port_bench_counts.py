"""The operation and byte counters against hand counts."""

import pytest

from port_bench import counts, peaks
from port_bench.counts import Dims, Step

YI = Dims(layers=32, hidden=4096, q_heads=32, kv_heads=4, head_dim=128,
          inter=11008, vocab=64000)
MISTRAL = Dims(layers=32, hidden=4096, q_heads=32, kv_heads=8, head_dim=128,
               inter=14336, vocab=32000, window=4096)


def brute_keys(start, n, window):
    return sum(min(p + 1, window or p + 1) for p in range(start, start + n))


def brute_rows(start, n, window):
    rows = set()
    for p in range(start, start + n):
        lo = 0 if window is None else max(0, p - window + 1)
        rows.update(range(lo, p + 1))
    return len(rows)


@pytest.mark.parametrize("window", [None, 1, 7, 64, 100])
@pytest.mark.parametrize("start,n", [(0, 1), (0, 50), (30, 40), (99, 1),
                                     (120, 77), (0, 0)])
def test_keys_and_rows_against_brute_force(window, start, n):
    assert counts.keys_attended(start, n, window) == brute_keys(start, n,
                                                                window)
    if n:
        assert counts.kv_rows(start, n, window) == brute_rows(start, n,
                                                              window)


def test_dims_from_the_configuration_files():
    import json

    from port_bench.cells import ROOT
    for name, want in (("yi-6b-200k", YI),):
        with open(ROOT / "configs" / f"{name}.json") as f:
            assert Dims.of(json.load(f)) == want


def test_step_flops_counts_every_layer():
    """A 2048-token chunk at depth 0 on Yi, by hand: the projections of
    all 32 layers, the head on one row, attention over 2048 * 2049 / 2
    keys in every layer (bench.py's count left the layers out)."""
    s = Step(t=0.0, chunks=[(2048, 0)], sampled=1)
    per_token = 2 * (4096 * (32 + 8) * 128 + 4096 * 4096
                     + 4096 * 2 * 11008 + 11008 * 4096)
    gemm = 32 * 2048 * per_token + 2 * 4096 * 64000
    attn = 4 * 32 * 128 * (2048 * 2049 // 2) * 32
    assert counts.step_flops(YI, s) == gemm + attn
    one_layer = Dims(**{**YI.__dict__, "layers": 1})
    assert counts.step_flops(YI, s) - gemm > 31 * (
        counts.step_flops(one_layer, s) - 2048 * per_token
        - 2 * 4096 * 64000)


def test_an_ungated_mlp_counts_one_up_projection():
    """A family whose MLP has no gate (``Dims.up`` = inter) counts one
    H x inter up projection, not two."""
    s = Step(t=0.0, decodes=[100], sampled=0)
    plain = Dims(**{**YI.__dict__, "up": YI.inter})
    assert counts.step_flops(YI, s) - counts.step_flops(plain, s) == (
        32 * 2 * 4096 * 11008)


def test_kv_bytes_per_token():
    assert counts.kv_bytes_per_token(YI) == 64 * 1024
    assert counts.kv_bytes_per_token(MISTRAL) == 128 * 1024


def test_mistral_window_caps_decode_and_prefill():
    d = Step(t=0.0, decodes=[10000, 100], sampled=2)
    f, b = counts.decode_attn(MISTRAL, d)
    assert f == 4 * 32 * 128 * (4096 + 100)
    kv = 2 * 8 * 128 * 2
    assert b == 2 * (2 * 32 * 128 * 2) + (4096 + 100) * kv
    p = Step(t=0.0, chunks=[(2048, 8192)])
    f, b = counts.prefill_attn(MISTRAL, p)
    assert f == 4 * 32 * 128 * 2048 * 4096
    assert b == 2048 * 2 * 32 * 128 * 2 + (2048 + 4095) * kv


def test_decode_bytes_are_the_least_a_call_can_move():
    """One sequence of one key: the bound is the bytes of q, o and one
    K/V row, so a call that moved only those would sit at 100%, never
    above."""
    s = Step(t=0.0, decodes=[1], sampled=1)
    f, b = counts.decode_attn(YI, s)
    assert b == 2 * 32 * 128 * 2 + 2 * 4 * 128 * 2
    t = counts.bound_s(f, b)
    assert t == b / peaks.HBM_BYTES_PER_S
    assert counts.attn_bound_s(YI, s, "decode") == 32 * t


def test_gemm_bound_is_per_call():
    """Each projection's call bounds alone: a decode step at batch 1 is
    bound by the weights' bytes, a 2048-token chunk by operations."""
    one = Step(t=0.0, decodes=[10], sampled=1)
    weights_bytes = 2 * 32 * (4096 * 5120 + 4096 * 4096 + 4096 * 22016
                              + 11008 * 4096) + 2 * 4096 * 64000
    bound = counts.gemm_bound_s(YI, one)
    assert weights_bytes / peaks.HBM_BYTES_PER_S < bound
    assert bound < 1.01 * weights_bytes / peaks.HBM_BYTES_PER_S
    big = Step(t=0.0, chunks=[(2048, 0)], sampled=1)
    flops = sum(n * f for n, f, _ in counts.gemm_calls(YI, 2048, 1))
    assert counts.gemm_bound_s(YI, big) == pytest.approx(
        flops / peaks.BF16_FLOPS, rel=0.02)
