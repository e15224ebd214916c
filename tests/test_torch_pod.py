"""The port's POD path (kernel F) against the JAX package's, on the CPU.

Kernel F's plain version against ``pod_fused_attention`` (Pallas interpret
mode, as tests/test_kernels.py runs it) on the three cases of
tests/test_kernels.py, with the same numpy-seeded q, cache and extents:
the JAX side gets ``build_pod_schedule`` and its extent tables, the port
``qt_run``, ``qinfo`` and ``tile_rows_from_segments`` tables.  Tolerance:
float32 attention within atol = rtol = 1e-4, as tests/test_torch_paged.py
(online vs full softmax, summed in other orders); idle decode slots are
exactly zero on both sides.  Then F's block order against the schedule's
tiles, and the port's engine on ``fa_pod`` and ``fa_pod_megacache`` against the
JAX engine's greedy tokens on the tests/test_e2e.py workload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import fresh_metrics, serve

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.ops.pod_fused import (build_pod_schedule,
                                          pod_fused_attention)
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.pod_fused import pod_attention
from vattention_tpu_torch.ops.utils import tile_rows_from_segments

L, HKV, HQ, D = 2, 2, 4, 64   # tests/test_kernels.py's geometry
R = 2048
S = 8
Q_TILE, KV_TILE = 128, 256
SUB = 256
TOL = 1e-4


def seg_tables(extents):
    """[(row, ntokens), ...] -> (seg_row [S], seg_cum [S+1])."""
    seg_row = np.zeros(S, np.int32)
    seg_cum = np.zeros(S + 1, np.int32)
    t = 0
    for j, (row, n) in enumerate(extents):
        seg_row[j], seg_cum[j] = row, t
        t += n
    seg_cum[len(extents):] = t
    return seg_row, seg_cum


def pod_case(seed, runs, dec_extents, dec_seqlens):
    """One case of tests/test_kernels.py::test_pod_fused_*: ``runs`` are
    (chunk, q_start, kv_len, extents); draws the cache, the prefill q
    (each run padded to the q tile) and the decode q in that file's order.
    Returns the JAX outputs and the port's plain outputs."""
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    K = len(runs)
    pre_row = np.zeros((K, S), np.int32)
    pre_cum = np.zeros((K, S + 1), np.int32)
    qinfo = np.zeros((K, 2), np.int32)
    qt_run, q_parts = [], []
    for r, (chunk, q_start, kv_len, extents) in enumerate(runs):
        pre_row[r], pre_cum[r] = seg_tables(extents)
        qinfo[r] = (q_start, kv_len)
        pad = -(-chunk // Q_TILE) * Q_TILE
        q_parts.append(rng.standard_normal((pad, HQ, D)))
        qt_run += [(r, lqt) for lqt in range(pad // Q_TILE)]
    qp = np.concatenate(q_parts).astype(np.float32)
    B = len(dec_seqlens)
    dec_row = np.zeros((B, S), np.int32)
    dec_cum = np.zeros((B, S + 1), np.int32)
    for b, extents in enumerate(dec_extents):
        dec_row[b], dec_cum[b] = seg_tables(extents)
    qd = rng.standard_normal((B, HQ, D)).astype(np.float32)
    seqlens = np.asarray(dec_seqlens, np.int32)

    sched = build_pod_schedule([r[0] for r in runs], Q_TILE, KV_TILE, qinfo,
                               seqlens)
    op, od = pod_fused_attention(
        jnp.asarray(qp), jnp.asarray(qd), jnp.asarray(cache),
        jnp.asarray(sched), jnp.asarray(pre_row), jnp.asarray(pre_cum),
        jnp.asarray(qinfo), jnp.ones(1, jnp.int32), jnp.asarray(dec_row),
        jnp.asarray(dec_cum), jnp.asarray(seqlens), q_tile=Q_TILE,
        kv_tile=KV_TILE, num_segments=S)
    n_sub = R // SUB
    got_p, got_d = pod_attention(
        torch.from_numpy(qp), torch.from_numpy(qd), torch.from_numpy(cache),
        torch.tensor(qt_run, dtype=torch.int32), torch.from_numpy(qinfo),
        torch.from_numpy(tile_rows_from_segments(pre_row, pre_cum, SUB,
                                                 n_sub)),
        torch.from_numpy(tile_rows_from_segments(dec_row, dec_cum, SUB,
                                                 n_sub)),
        torch.from_numpy(seqlens), 1, sub=SUB, pad_tile=Q_TILE,
        sm_scale=D ** -0.5)
    return (np.asarray(op), np.asarray(od)), (got_p.numpy(), got_d.numpy())


def test_pod_matches_pod_fused_attention_single_run():
    """tests/test_kernels.py:214: chunk 128 at depth 640; 3 slots, one
    idle."""
    (op, od), (gp, gd) = pod_case(
        9, [(128, 512, 640, [(0, 1024)])],
        [[(1024, 512)], [(1536, 256)], [(0, 256)]], [500, 200, 0])
    np.testing.assert_allclose(gp, op, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gd, od, atol=TOL, rtol=TOL)
    assert not gd[2].any() and not od[2].any()


def test_pod_matches_pod_fused_attention_long_weave():
    """tests/test_kernels.py:268: 4 q tiles at depth 1024, 4 slots."""
    (op, od), (gp, gd) = pod_case(
        17, [(512, 512, 1024, [(0, 1024)])],
        [[(1024 + b * 256, 256)] for b in range(4)],
        [100 + 37 * b for b in range(4)])
    np.testing.assert_allclose(gp, op, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gd, od, atol=TOL, rtol=TOL)


def test_pod_matches_pod_fused_attention_multi_prefill():
    """tests/test_kernels.py:319: 2 runs (a 130-token chunk padded to 256,
    over two extents) and 2 slots.  The padding rows agree too: both sides
    place them past the chunk and mask them the same way."""
    runs = [(256, 512, 768, [(0, 1024)]),
            (130, 254, 384, [(1024, 256), (1280, 256)])]
    (op, od), (gp, gd) = pod_case(
        23, runs, [[(1536 + b * 256, 256)] for b in range(2)], [300, 128])
    np.testing.assert_allclose(gp, op, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gd, od, atol=TOL, rtol=TOL)


def block_role(t, n_pre):
    """Kernel F's block order (csrc/pod_attention.cu): (0, prefill block t)
    while t < ``n_pre``, then (1, block t - n_pre of kernel C's grid)."""
    return (0, t) if t < n_pre else (1, t - n_pre)


@pytest.mark.parametrize("chunks,qinfo,seqlens", [
    ([128], [(512, 640)], [500, 200, 0]),
    ([512], [(512, 1024)], [100, 137, 174, 211]),
    ([256, 130], [(512, 768), (254, 384)], [300, 128]),
    ([512, 512, 128], [(0, 512), (3584, 4096), (0, 128)],
     [0, 1, 17, 512, 1000, 2048, 3000, 4096]),
    ([128], [(0, 128)], [8192] * 8),
])
def test_block_weave_is_the_schedule_weave(chunks, qinfo, seqlens):
    """Kernel F gives one block to each prefill tile of
    build_pod_schedule, in the schedule's order, and launches them first:
    its prefill blocks are the schedule's prefill entries.  The TPU weaves
    the roles evenly on its one core; on the H100 a bf16 F block fills an
    SM, so F drops the weave.  Its decode blocks follow as kernel C's
    fixed grid, which plans its splits over the live depths on the device
    (tests/test_torch_decode.py) instead of the schedule's decode tiles."""
    sched = build_pod_schedule(chunks, Q_TILE, KV_TILE, np.array(qinfo),
                               np.array(seqlens))
    phases = sched[:, 0].tolist()
    n = sum(p != 2 for p in phases)
    assert all(p == 2 for p in phases[n:])
    n_pre = phases.count(0)
    # each prefill entry's rank among the schedule's prefill entries
    rank = [phases[:t].count(0) for t in range(n) if phases[t] == 0]
    assert [block_role(t, n_pre) for t in range(n_pre)] == [(0, r)
                                                            for r in rank]
    assert block_role(n_pre, n_pre) == (1, 0)


ENGINE_KW = dict(model="tiny-llama-debug", dtype="float32",
                 scheduler_type="sarathi", max_model_len=512,
                 max_batch_size=4, max_num_seqs=4, chunk_size=128,
                 gpu_memory_utilization=0.9)
_rng = np.random.default_rng(5)
PROMPTS = {f"r{i}": _rng.integers(1, 2000, int(n)).tolist()
           for i, n in enumerate([200, 37])}


@pytest.fixture(scope="module")
def jax_pod_run():
    """The JAX engine on fa_pod over the tests/test_e2e.py workload: its
    tokens, weights and arena geometry.  The JAX package resolves
    fa_pod_megacache to this same engine (first prefix match)."""
    fresh_metrics()
    jax_engine = JaxLLMEngine.from_engine_args(**ENGINE_KW,
                                               attention_backend="fa_pod")
    expect = serve(jax_engine, JaxSamplingParams, PROMPTS, 6)
    np_params = jax.tree.map(np.asarray,
                             jax_engine.worker.model_runner.params)
    block = jax_engine.worker.cache_engine.block_tokens
    jax_engine.cleanup()
    fresh_metrics()
    return expect, np_params, block


@pytest.mark.parametrize("backend", ["fa_pod", "fa_pod_megacache"])
def test_port_pod_engine_matches_jax_engine(jax_pod_run, backend):
    expect, np_params, jax_block = jax_pod_run
    fresh_metrics()
    engine = LLMEngine.from_engine_args(**ENGINE_KW,
                                        attention_backend=backend,
                                        load_format="zero", device="cpu")
    ce = engine.worker.cache_engine
    # the port's fa_pod_megacache is the megacache arena, whose blocks span
    # both layers
    layers = 2 if backend == "fa_pod_megacache" else 1
    assert type(ce).__name__ == "VAttnCacheEngine"
    assert ce.block_tokens * layers == jax_block
    runner = engine.worker.model_runner
    runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, PROMPTS, 6)
    assert got == expect
    assert runner.backend.pod_steps > 0
    assert engine.metrics_store.num_preempted == 0
    engine.cleanup()
    fresh_metrics()
