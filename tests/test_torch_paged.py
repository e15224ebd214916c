"""The port's paged baseline against the JAX package's, on the CPU.

Kernel E's plain version against ``paged_flash_prefill_multi`` and the
port's paged decode against ``paged_flash_decode`` (Pallas interpret mode,
as tests/test_kernels.py runs them), on numpy-seeded inputs whose block
tables hold 2**30 past each run's or slot's last valid block: neither side
may read there.  Tolerance: float32 attention within atol = rtol = 1e-4,
as tests/test_torch_ops.py (online vs full softmax sum in other orders).
Then the paged cache engine's bookkeeping against the JAX engine's over a
scripted run, and the port's engine against the JAX engine's greedy tokens
on the tests/test_e2e.py workload for the paged and the routed backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import fresh_metrics, serve

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.ops.paged_attention import (paged_flash_decode,
                                                paged_flash_prefill_multi)
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                      paged_prefill_attention,
                                                      paged_tile_rows)

L, HKV, HQ, D = 2, 2, 4, 128
R = 2048          # pool rows
TOL = 1e-4
POISON = 2 ** 30  # a block id far past the pool


def make_cache(rng):
    return rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)


def poisoned_tables(blocks_per_row, nb):
    """[[block ids], ...] -> [len, nb] int32 with POISON past each row's
    blocks (entry 0 stays a real block, which both sides' clamps may
    name for an empty row)."""
    tables = np.full((len(blocks_per_row), nb), POISON, np.int32)
    for r, blocks in enumerate(blocks_per_row):
        tables[r, :max(len(blocks), 1)] = blocks or [0]
    return tables


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bs,kv_fetch", [(256, 1), (32, 8)])
def test_paged_prefill_matches_paged_flash_prefill_multi(bs, kv_fetch):
    """bs 256: out-of-order blocks (tests/test_kernels.py:560); bs 32:
    permuted blocks, the JAX side fetching 8 per tile (:739).  A tail q
    tile maps to the empty run, which gives zeros on both sides."""
    rng = np.random.default_rng(10 + bs)
    cache = make_cache(rng)
    q_tile = 128
    if bs == 256:
        blocks = [[5, 0, 3], [2, 7]]
    else:
        blocks = [rng.permutation(R // bs)[:22].tolist(),
                  rng.permutation(R // bs)[:12].tolist()]
    runs = [dict(kv_len=700, q_start=400, chunk=300),
            dict(kv_len=384, q_start=0, chunk=384)]
    tables = poisoned_tables(blocks + [[]], max(map(len, blocks)) + 3)
    qinfo = np.array([[r["q_start"], r["kv_len"]] for r in runs] + [[0, 0]],
                     np.int32)
    qt_run, offs, off = [], [], 0
    for r, spec in enumerate(runs):
        pad = -(-spec["chunk"] // q_tile) * q_tile
        offs.append(off)
        qt_run += [(r, lqt) for lqt in range(pad // q_tile)]
        off += pad
    qt_run.append((len(runs), 0))
    qt_run = np.array(qt_run, np.int32)
    q = rng.standard_normal((len(qt_run) * q_tile, HQ, D)).astype(np.float32)
    NB = tables.shape[1]
    expect = np.asarray(paged_flash_prefill_multi(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
        jnp.asarray(qinfo), jnp.asarray(qt_run), jnp.asarray([1], jnp.int32),
        q_tile=q_tile, block_size=bs, max_kv_tiles=-(-NB // kv_fetch),
        kv_fetch=kv_fetch))
    got = paged_prefill_attention(
        t(q), t(cache), t(qt_run), t(qinfo), t(tables), 1, block_size=bs,
        pad_tile=q_tile, sm_scale=D ** -0.5).numpy()
    for r, spec in enumerate(runs):
        sl = slice(offs[r], offs[r] + spec["chunk"])
        np.testing.assert_allclose(got[sl], expect[sl], atol=TOL, rtol=TOL,
                                   err_msg=f"run {r}")
    tail = slice(off, None)
    assert not got[tail].any() and not expect[tail].any()


@pytest.mark.parametrize("bs", [256, 16])
def test_paged_decode_matches_paged_flash_decode(bs):
    """Slots of depth 0, 1, a block boundary and non-aligned depths."""
    rng = np.random.default_rng(20 + bs)
    cache = make_cache(rng)
    seqlens = np.array([0, 1, 250, 513, bs, 700], np.int32)
    perm = rng.permutation(R // bs)
    blocks, used = [], 0
    for n in seqlens:
        k = -(-int(n) // bs)
        blocks.append(perm[used:used + k].tolist())
        used += k
    tables = poisoned_tables(blocks, -(-int(seqlens.max()) // bs) + 2)
    q = rng.standard_normal((len(seqlens), HQ, D)).astype(np.float32)
    expect = np.asarray(paged_flash_decode(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
        jnp.asarray(seqlens), jnp.zeros(1, jnp.int32), block_size=bs))
    got = paged_decode_attention(t(q), t(cache), t(tables), t(seqlens), 0,
                                 block_size=bs, sm_scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    assert not got[0].any() and np.isfinite(got).all()
    # the row table names no poisoned entry
    rows = paged_tile_rows(t(tables), t(seqlens), bs).numpy()
    assert rows.max() < R and rows.min() >= 0


def cache_engine_trace(pkg):
    """A scripted run of chunked prefills, decodes and frees through one
    package's PagedCacheEngine; returns its bookkeeping after each step."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    config = mod("engine.arg_utils").EngineArgs(
        model="tiny-llama-debug", dtype="float32",
        attention_backend="fa_paged_16", max_model_len=512,
        max_batch_size=4).create_engine_configs()
    config.cache_config.memory_for_gpu = 40 * 16 * 2 * 2 * 2 * 128 * 4
    engine_cls = mod("worker.cache_engine.paged_cache_engine").PagedCacheEngine
    ce = (engine_cls(config, torch.device("cpu")) if pkg.endswith("torch")
          else engine_cls(config))
    seq_mod = mod("core.datatypes.sequence")
    status = mod("core.datatypes.sequence_status").SequenceStatus
    sp = mod("core.datatypes.sampling_params").SamplingParams(
        temperature=0.0, max_tokens=64, ignore_eos=True)
    seqs = {name: seq_mod.Sequence(name, None, list(range(1, n + 1)), 16,
                                   -1, 0.0, sp)
            for name, n in (("a", 100), ("b", 37), ("c", 200), ("d", 64))}
    # (seq, chunk) per step: chunk 0 is a decode step
    script = [[("a", 64), ("b", 37)], [("a", 36), ("b", 0)],
              [("a", 0), ("b", 0), ("c", 128)], "free b",
              [("c", 72), ("a", 0), ("d", 64)], [("c", 0), ("d", 0)],
              "free a", [("c", 0), ("d", 0)]]
    log = []
    for step in script:
        if isinstance(step, str):
            ce.free_seq(step.split()[1])
        else:
            metas = [seq_mod.SequenceMetadata(seqs[s], c) for s, c in step]
            ce.step(metas)
            for s, c in step:
                seq = seqs[s]
                seq.set_status(status.RUNNING)
                if c:
                    seq.update_prompt_tokens_processed(c)
                else:
                    seq.append_token_id(7)
        table, ntok = ce.get_batch_segments()
        rows = {s: ce.get_slot_rows(ce.slot_of(s), 0,
                                    16 * len(ce.tables[s])).tolist()
                for s in ce.batch_idx}
        log.append((dict(ce.tables), dict(ce.batch_idx),
                    list(ce.free_blocks), list(ce.free_slots),
                    table.tolist(), ntok.tolist(), rows,
                    ce.get_free_blocks()))
    assert ce.num_blocks == 40 and ce.table_width == 32
    return log


def test_paged_cache_engine_matches_jax_engine():
    jax_log, torch_log = (cache_engine_trace(p)
                          for p in ("vattention_tpu", "vattention_tpu_torch"))
    assert torch_log == jax_log


def test_paged_pool_exhaustion_raises_the_jax_message():
    from vattention_tpu_torch.engine.arg_utils import EngineArgs
    from vattention_tpu_torch.worker.cache_engine.paged_cache_engine import (
        PagedCacheEngine)
    from vattention_tpu_torch.core.datatypes.sampling_params import (
        SamplingParams as SP)
    from vattention_tpu_torch.core.datatypes.sequence import (
        Sequence, SequenceMetadata)

    config = EngineArgs(model="tiny-llama-debug", dtype="float32",
                        attention_backend="fa_paged_16", max_model_len=512,
                        max_batch_size=2).create_engine_configs()
    config.cache_config.memory_for_gpu = 3 * 16 * 2 * 2 * 2 * 128 * 4
    ce = PagedCacheEngine(config, torch.device("cpu"))
    assert ce.num_blocks == 3
    seq = Sequence("x", None, list(range(1, 65)), 16, -1, 0.0,
                   SP(temperature=0.0, max_tokens=4))
    with pytest.raises(RuntimeError, match="OOM on demand: paged pool"):
        ce.step([SequenceMetadata(seq, 64)])


@pytest.mark.parametrize("backend", ["fa_paged_128", "fa_paged_16",
                                     "fa_vattn_megacache", "fi_unpaged",
                                     "no_op"])
def test_port_engine_matches_jax_engine(backend):
    """fa_paged_128 is tests/test_e2e.py's paged case; fa_paged_16 has a
    32-row table per request; the last three route to the vattn arena
    (no_op skipping attention) in both packages."""
    fresh_metrics()
    kw = dict(model="tiny-llama-debug", dtype="float32",
              attention_backend=backend, scheduler_type="sarathi",
              max_model_len=512, max_batch_size=4, max_num_seqs=4,
              chunk_size=128, gpu_memory_utilization=0.9)
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([200, 37])}
    jax_engine = JaxLLMEngine.from_engine_args(**kw)
    expect = serve(jax_engine, JaxSamplingParams, prompts, 6)
    np_params = jax.tree.map(np.asarray,
                             jax_engine.worker.model_runner.params)
    jax_ce = jax_engine.worker.cache_engine
    jax_geometry = (type(jax_ce).__name__, jax_ce.block_tokens)
    jax_engine.cleanup()

    engine = LLMEngine.from_engine_args(**kw, load_format="zero",
                                        device="cpu")
    ce = engine.worker.cache_engine
    # the port's fa_vattn_megacache is the megacache arena, whose blocks
    # span both layers; the JAX package resolves the name to fa_vattn
    layers = 2 if backend == "fa_vattn_megacache" else 1
    assert (type(ce).__name__, ce.block_tokens * layers) == jax_geometry
    engine.worker.model_runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, prompts, 6)
    assert got == expect
    assert engine.metrics_store.num_preempted == 0
    engine.cleanup()
    fresh_metrics()
