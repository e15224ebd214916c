"""The sliding window (Mistral-7B's) in the PyTorch port, on the CPU.

Ops: the same numpy-seeded inputs go through the JAX kernels with
``window`` (Pallas interpret mode, as tests/test_kernels.py runs them) and
through the port's wrappers on CPU tensors, which take the plain versions:
kernel B against ``flash_prefill_multi``, G against ``flash_prefill``, C
against ``flash_decode``, at windows 1, 63, 64, 65, 300 and one past every
depth, with q starts on and off 64-key tile edges and decode depths of
``window - 1``, ``window``, ``window + 1`` and far past it.  float32,
atol = rtol = 1e-4 (online against full softmax, sums in other orders),
on each run's real rows: a padding row at least ``window`` past kv_len
sees no key, which the JAX kernel leaves undefined and the port sets to
zero.  Idle decode slots are exactly zero.  E, H and F's plain versions
must equal B's, G's and B's then C's on the same rows, and a window past
every depth must give the unwindowed bits.

Engines: a tiny windowed model (a ``config.json`` with model_type
"mistral", tiny-llama-debug's widths and ``sliding_window`` 96) served
greedily by the JAX fa_vattn engine; its weights go through
``params_from_jax`` into the port's fa_vattn, fa_vattn_64kb, fa_paged_16
and fa_pod engines (device="cpu"), which must give the same tokens on
prompts of 200 and 37 tokens (the window bites on the first).  The JAX
paged and POD backends are built without the window: on a windowed model
they attend past it, so the port's fa_paged and fa_pod, which apply it,
are held to the JAX fa_vattn engine (ROADMAP Queue 3).  Last, the window
bites: a dense float32 reference with and without it gives logits that
differ, and the port's windowed and unwindowed engines each follow their
own reference's tokens.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.ops import utils as jutils
from vattention_tpu.ops.flash_decode import flash_decode
from vattention_tpu.ops.flash_prefill import (flash_prefill,
                                              flash_prefill_multi)
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import (prefill_attention,
                                                    segment_prefill_attention,
                                                    segment_rows)
from vattention_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_prefill_attention,
    paged_prefill_attention_single)
from vattention_tpu_torch.ops.pod_fused import pod_attention

L, HKV, HQ, D = 2, 2, 4, 128
R = 2048          # arena rows
S = 8             # extent budget
SUB = 128         # rows per table entry (the kv tile of the Pallas calls)
PAD = 128         # the q tile
TOL = 1e-4
SM = D ** -0.5
PAST = 10_000     # a window past every depth here
WINDOWS = [1, 63, 64, 65, 300, PAST]
# (extents, q_start, chunk): a q start on a 64-key tile edge, one off it,
# a first chunk, then the empty run
RUNS = [([(0, 256), (1024, 256)], 128, 200),
        ([(512, 384)], 200, 150),
        ([(1536, 128)], 0, 60),
        ([], 0, 0)]


def t(x):
    return torch.from_numpy(np.array(x))


def seg_tables(extents_per_seq):
    """[[(row, ntokens), ...] per sequence] -> (seg_row [B, S],
    seg_cum [B, S+1])."""
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


def prefill_inputs(seed):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    seg_row, seg_cum = seg_tables([ext for ext, _, _ in RUNS])
    qinfo = np.array([[q0, q0 + c] for _, q0, c in RUNS], np.int32)
    qt_run, real, off = [], [], 0
    for r, (_, _, c) in enumerate(RUNS):
        tiles = max(-(-c // PAD), 1)
        qt_run += [(r, i) for i in range(tiles)]
        real.append((off, off + c))
        off += tiles * PAD
    q = rng.standard_normal((off, HQ, D)).astype(np.float32)
    tile_rows = jutils.tile_rows_from_segments(seg_row, seg_cum, SUB,
                                               R // SUB)
    return (cache, q, seg_row, seg_cum, qinfo, np.array(qt_run, np.int32),
            tile_rows, real)


@pytest.mark.parametrize("window", WINDOWS)
def test_prefill_b_and_g_match_the_jax_kernels(window):
    """B against ``flash_prefill_multi`` over three runs (q starts 128 and
    200, a first chunk, the empty run), G against ``flash_prefill`` on the
    first run alone; with a window past every depth B gives the unwindowed
    bits."""
    cache, q, seg_row, seg_cum, qinfo, qt_run, tile_rows, real = \
        prefill_inputs(1)
    expect = np.asarray(flash_prefill_multi(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(seg_row),
        jnp.asarray(seg_cum), jnp.asarray(qinfo), jnp.asarray(qt_run),
        jnp.asarray([1], jnp.int32), jnp.asarray(tile_rows), q_tile=PAD,
        kv_tile=SUB, num_segments=S, max_kv_tiles=R // SUB, window=window))
    args = (t(q), t(cache), t(qt_run), t(qinfo), t(tile_rows), 1)
    got = prefill_attention(*args, sub=SUB, pad_tile=PAD, sm_scale=SM,
                            window=window).numpy()
    for lo, hi in real:
        np.testing.assert_allclose(got[lo:hi], expect[lo:hi], atol=TOL,
                                   rtol=TOL)
    assert not got[real[-1][0]:].any()   # the empty run's tile
    if window == PAST:
        unwindowed = prefill_attention(*args, sub=SUB, pad_tile=PAD,
                                       sm_scale=SM).numpy()
        for lo, hi in real:
            np.testing.assert_array_equal(got[lo:hi], unwindowed[lo:hi])

    _, q0, chunk = RUNS[0]
    g_expect = np.asarray(flash_prefill(
        jnp.asarray(q[:2 * PAD]), jnp.asarray(cache),
        jnp.asarray(seg_row[0]), jnp.asarray(seg_cum[0]),
        jnp.asarray([q0, q0 + chunk, 1], jnp.int32), q_tile=PAD,
        kv_tile=SUB, num_segments=S, window=window))
    g = segment_prefill_attention(
        t(q[:2 * PAD]), t(cache), t(seg_row[0]), t(seg_cum[0]),
        t(qinfo[0]), 1, sm_scale=SM, window=window).numpy()
    np.testing.assert_allclose(g[:chunk], g_expect[:chunk], atol=TOL,
                               rtol=TOL)


def decode_inputs(seed, depths):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    n_sub = 8
    tile_rows = np.stack([rng.permutation(R // SUB)[:n_sub] * SUB
                          for _ in depths]).astype(np.int32)
    q = rng.standard_normal((len(depths), HQ, D)).astype(np.float32)
    return cache, q, tile_rows, np.asarray(depths, np.int32)


def window_depths(window):
    """Depths around the window's edge and far past it, an idle slot and
    a shallow one."""
    if window == PAST:
        return [1, 64, 300, 0, 1000]
    return [max(window - 1, 1), window, window + 1, 3 * window + 50, 0, 5]


@pytest.mark.parametrize("window", WINDOWS)
def test_decode_c_matches_flash_decode(window):
    """C against ``flash_decode`` at depths ``window - 1``, ``window``,
    ``window + 1`` and far past it; the idle slot exactly zero; a window
    past every depth gives the unwindowed bits."""
    depths = window_depths(window)
    cache, q, tile_rows, seqlens = decode_inputs(2, depths)
    expect = np.asarray(flash_decode(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tile_rows),
        jnp.asarray(seqlens), jnp.ones(1, jnp.int32), kv_tile=SUB,
        max_kv_tiles=8, window=window))
    args = (t(q), t(cache), t(tile_rows), t(seqlens), 1)
    got = decode_attention(*args, sub=SUB, sm_scale=SM,
                           window=window).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    idle = depths.index(0)
    assert not got[idle].any() and np.isfinite(got).all()
    if window == PAST:
        np.testing.assert_array_equal(
            got, decode_attention(*args, sub=SUB, sm_scale=SM).numpy())


@pytest.mark.parametrize("window", [1, 65, 300])
def test_e_h_and_f_equal_b_g_and_c_on_the_same_rows(window):
    """E's, H's and F's windowed plain versions equal B's, G's and B's then
    C's on the same rows, bit for bit (block tables of 16-token blocks
    naming B's rows; the paged decode over them equals C)."""
    cache, q, seg_row, seg_cum, qinfo, qt_run, tile_rows, _ = \
        prefill_inputs(3)
    bs = 16
    width = R // bs
    tables = np.zeros((len(RUNS), width), np.int32)
    for r, (_, q0, c) in enumerate(RUNS):
        rows = segment_rows(t(seg_row[r]), t(seg_cum[r]), q0 + c).numpy()
        tables[r, :len(rows[::bs])] = rows[::bs] // bs
    kw = dict(pad_tile=PAD, sm_scale=SM, window=window)
    b = prefill_attention(t(q), t(cache), t(qt_run), t(qinfo), t(tile_rows),
                          0, sub=SUB, **kw)
    e = paged_prefill_attention(t(q), t(cache), t(qt_run), t(qinfo),
                                t(tables), 0, block_size=bs, **kw)
    assert torch.equal(e, b)
    q0, c = RUNS[0][1:]
    g = segment_prefill_attention(t(q[:2 * PAD]), t(cache), t(seg_row[0]),
                                  t(seg_cum[0]), t(qinfo[0]), 0, sm_scale=SM,
                                  window=window)
    h = paged_prefill_attention_single(t(q[:2 * PAD]), t(cache),
                                       t(tables[0]), t(qinfo[0]), 0,
                                       block_size=bs, sm_scale=SM,
                                       window=window)
    assert torch.equal(h, g)
    depths = window_depths(window)
    dcache, qd, drows, seqlens = decode_inputs(4, depths)
    dcache = t(cache)   # the prefill's arena: one cache for F
    c_out = decode_attention(t(qd), dcache, t(drows), t(seqlens), 0,
                             sub=SUB, sm_scale=SM, window=window)
    f_p, f_d = pod_attention(t(q), t(qd), dcache, t(qt_run), t(qinfo),
                             t(tile_rows), t(drows), t(seqlens), 0, sub=SUB,
                             **kw)
    assert torch.equal(f_p, b) and torch.equal(f_d, c_out)
    blocks = torch.from_numpy(drows // SUB)
    paged = paged_decode_attention(t(qd), dcache, blocks, t(seqlens), 0,
                                   block_size=SUB, sm_scale=SM,
                                   window=window)
    assert torch.equal(paged, c_out)


# ---------------------------------------------------------------------- #
# engines on a tiny windowed model
# ---------------------------------------------------------------------- #
WINDOW = 96
TINY = dict(num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=128, hidden_size=256,
            intermediate_size=688, vocab_size=2048,
            max_position_embeddings=8192)
PROMPT_LENS = [200, 37]
MAX_TOKENS = 6


def serve(engine, sampling_cls, prompts, max_tokens):
    for seq_id, ids in prompts.items():
        engine.add_request(
            prompt=None, prompt_token_ids=ids,
            sampling_params=sampling_cls(temperature=0.0,
                                         max_tokens=max_tokens,
                                         ignore_eos=True),
            seq_id=seq_id)
    out = {}
    steps = 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        assert steps < 500
    return out


def fresh_metrics():
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore as T

    J._instance = None
    T._instance = None


def write_config(path, **extra):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({**TINY, **extra}))
    return str(path)


def engine_args(model, backend):
    return dict(model=model, dtype="float32", attention_backend=backend,
                scheduler_type="sarathi", max_model_len=512,
                max_batch_size=4, max_num_seqs=4, chunk_size=128,
                gpu_memory_utilization=0.9)


@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """(model dir, prompts, the JAX fa_vattn engine's tokens, its weights
    as numpy)."""
    fresh_metrics()
    model = write_config(tmp_path_factory.mktemp("mistral"),
                         model_type="mistral", sliding_window=WINDOW)
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, n).tolist()
               for i, n in enumerate(PROMPT_LENS)}
    engine = JaxLLMEngine.from_engine_args(**engine_args(model, "fa_vattn"))
    assert engine.worker.model_runner.backend.sliding_window == WINDOW
    expect = serve(engine, JaxSamplingParams, prompts, MAX_TOKENS)
    np_params = jax.tree.map(np.asarray, engine.worker.model_runner.params)
    engine.cleanup()
    fresh_metrics()
    return model, prompts, expect, np_params


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_vattn_64kb",
                                     "fa_paged_16", "fa_pod"])
def test_port_engines_match_the_jax_windowed_engine(windowed, backend):
    model, prompts, expect, np_params = windowed
    fresh_metrics()
    engine = LLMEngine.from_engine_args(**engine_args(model, backend),
                                        load_format="zero", device="cpu")
    runner = engine.worker.model_runner
    assert runner.model.arch.sliding_window == WINDOW
    assert runner.backend.window == WINDOW
    runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, prompts, MAX_TOKENS)
    assert got == expect
    if backend == "fa_pod":
        assert runner.backend.pod_steps > 0
    engine.cleanup()
    fresh_metrics()


@pytest.mark.parametrize("backend", ["fa_paged_16", "fa_pod"])
def test_jax_paged_and_pod_backends_drop_the_window(windowed, backend):
    """The divergence the port does not copy (ROADMAP Queue 3): the JAX
    runner builds its paged backend without the model's window, and its
    POD backend, which keeps the window for single-phase steps, calls
    ``pod_fused_attention``, which takes none, on mixed steps."""
    import inspect

    from vattention_tpu.ops.pod_fused import pod_fused_attention

    model = windowed[0]
    fresh_metrics()
    engine = JaxLLMEngine.from_engine_args(**engine_args(model, backend))
    runner = engine.worker.model_runner
    assert runner.model.arch.sliding_window == WINDOW
    if backend == "fa_paged_16":
        assert getattr(runner.backend, "sliding_window", None) is None
    else:
        assert "window" not in inspect.signature(
            pod_fused_attention).parameters
    engine.cleanup()
    fresh_metrics()


def dense_logits(model, params, ids, window):
    """Last-position logits of a float32 full-recompute forward of the
    port's llama body, attention through ``mha_reference`` with
    ``window``."""
    from vattention_tpu_torch.model_executor.layers.activation import (
        silu_and_mul)
    from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
    from vattention_tpu_torch.ops.attention_ref import mha_reference

    a, D_ = model.arch, model.head_dim
    lp = params["layers"]
    T = len(ids)
    x = params["embed"][torch.tensor(ids)]
    for layer in range(a.num_layers):
        h = rms_norm(x, lp["input_norm"][layer], a.rms_norm_eps)
        qkv = h @ lp["qkv_w"][layer]
        q = qkv[:, :model.hq * D_].reshape(T, model.hq, D_)
        k = qkv[:, model.hq * D_:(model.hq + model.hkv) * D_].reshape(
            T, model.hkv, D_)
        v = qkv[:, (model.hq + model.hkv) * D_:].reshape(T, model.hkv, D_)
        q, k = model.rope(torch.arange(T), q, k)
        attn = mha_reference(q, k, v, causal=True, sm_scale=model.sm_scale,
                             window=window)
        x = x + attn.reshape(T, model.hq * D_) @ lp["o_w"][layer]
        h2 = rms_norm(x, lp["post_norm"][layer], a.rms_norm_eps)
        x = x + silu_and_mul(h2 @ lp["gate_up_w"][layer]) @ lp["down_w"][layer]
    x = rms_norm(x, params["final_norm"], a.rms_norm_eps)
    return x[-1] @ params["lm_head"]


def test_the_window_bites(windowed, tmp_path):
    """On the 200-token prompt the windowed and unwindowed dense references
    give logits that differ by more than 0.01; the port's windowed engine
    (mistral, window 96) follows the windowed reference's greedy tokens
    and an unwindowed engine (the same widths and weights as a llama)
    the unwindowed reference's."""
    model, prompts, _, np_params = windowed
    plain = write_config(tmp_path / "llama", model_type="llama")
    ids = prompts["r0"]
    got = {}
    for name, path, window in (("windowed", model, WINDOW),
                               ("unwindowed", plain, None)):
        fresh_metrics()
        engine = LLMEngine.from_engine_args(**engine_args(path, "fa_vattn"),
                                            load_format="zero",
                                            device="cpu")
        runner = engine.worker.model_runner
        runner.params = params = params_from_jax(np_params)
        got[name] = serve(engine, SamplingParams, {"r0": ids}, 3)["r0"]
        ref = list(ids)
        for _ in range(3):
            ref.append(int(torch.argmax(dense_logits(runner.model, params,
                                                     ref, window))))
        assert got[name] == ref[len(ids):], name
        engine.cleanup()
        fresh_metrics()
    with torch.no_grad():
        gap = (dense_logits(runner.model, params, ids, WINDOW)
               - dense_logits(runner.model, params, ids, None)).abs().max()
    assert gap > 0.01


def test_kernel_sweep_takes_a_window(capsys):
    """``kernel_sweep --window`` with ``--cpu --check``: G, H and C under
    the window held against their plain versions, and the bytes counted
    over the rows the window lets each call read."""
    from vattention_tpu_torch.microbenchmarks import kernel_sweep

    rows = kernel_sweep.sweep(kernel_sweep.parser().parse_args(
        ["--cpu", "--check", "--ctx", "256", "512", "--batch", "2",
         "--kv-heads", "2", "--q-heads", "4", "--iters", "1",
         "--window", "100"]))
    out = capsys.readouterr().out
    for kernel in ("G", "H (bs 256)", "C (sub 256)"):
        assert f"# check {kernel} ctx 512: max abs err 0.0" in out
    assert [r[:3] for r in rows[:4]] == [
        ("prefill", "vattn_contig", 256), ("prefill", "paged", 256),
        ("decode", "vattn_contig", 256), ("decode", "paged", 256)]
