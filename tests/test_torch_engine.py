"""The PyTorch port's engine against the JAX engine, on the CPU.

The JAX engine serves a tests/test_e2e.py workload once; its weights go
through ``params_from_jax`` into the port's engine (device="cpu", so every
kernel takes its plain version), which must produce the same greedy
tokens.  float32 throughout: the two packages sum in different orders, and
float32 keeps those differences far below any argmax gap.
"""

import jax
import numpy as np
import pytest
import torch

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax


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


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_vattn_64kb"])
def test_port_engine_matches_jax_engine(backend):
    """fa_vattn: one extent per request; fa_vattn_64kb: 64-token blocks,
    so prompts span several extents and the row tables matter."""
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
    jax_block = jax_engine.worker.cache_engine.block_tokens
    jax_engine.cleanup()

    engine = LLMEngine.from_engine_args(**kw, load_format="zero",
                                        device="cpu")
    assert engine.worker.cache_engine.block_tokens == jax_block
    engine.worker.model_runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, prompts, 6)
    assert got == expect
    assert engine.metrics_store.num_preempted == 0
    engine.cleanup()
    fresh_metrics()


def test_cache_engine_applies_a_chained_plan():
    """The cache engine runs a relocation plan in plan order over every
    layer, K/V and head (kernel D's plain version on the CPU): block 1
    must leave for block 3 before block 0 lands on it."""
    from vattention_tpu_torch.memory.allocator import (Relocation,
                                                       RelocationPlan)

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32",
        attention_backend="fa_vattn_64kb", max_model_len=512,
        max_batch_size=2, gpu_memory_utilization=0.01, device="cpu")
    ce = engine.worker.cache_engine
    assert ce.allocator.num_arena_blocks >= 4
    bt = ce.block_tokens
    gen = torch.Generator().manual_seed(0)
    ce.kv_cache.copy_(torch.randn(ce.kv_cache.shape, generator=gen))
    before = ce.kv_cache.clone()
    ce._apply_plan(RelocationPlan([Relocation(1, 3), Relocation(0, 1)]))

    def block(t, b):
        return t[:, :, :, b * bt:(b + 1) * bt]

    assert torch.equal(block(ce.kv_cache, 3), block(before, 1))
    assert torch.equal(block(ce.kv_cache, 1), block(before, 0))
    assert torch.equal(block(ce.kv_cache, 2), block(before, 2))
    assert ce.pending_moves == 2
    engine.cleanup()
    fresh_metrics()


def test_engine_defaults_to_cuda():
    """Without a GPU an engine that was not asked for the CPU raises; it
    never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fresh_metrics()
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine.from_engine_args(model="tiny-llama-debug",
                                   max_model_len=256, max_batch_size=2)


@pytest.mark.parametrize("backend", [
    "fa_vattn_sync", "fi_vattn", "fa3_vattn_sync", "fa_vattn_megacache_sync",
    "fa_streams_megacache", "fi_unpaged", "no_op", "fi_paged",
    "fi_serial_paged_32", "fa_pod", "fa_pod_megacache"])
def test_backends_route_as_the_jax_factory(backend):
    """Each name reaches the cache engine the JAX factory gives it (the
    contiguous-arena names and no_op the vattn arena, the rest the paged
    pool), ``*_sync`` runs the allocator's synchronous step, and a short
    request is served through it."""
    from vattention_tpu.model_executor.attention import AttentionBackend as J

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32", attention_backend=backend,
        max_model_len=256, max_batch_size=2, device="cpu")
    ce = engine.worker.cache_engine
    vattn = J.is_vATTN(backend) or J.is_no_op(backend)
    assert type(ce).__name__ == ("VAttnCacheEngine" if vattn
                                 else "PagedCacheEngine")
    assert getattr(ce, "sync_mode", False) == backend.endswith("_sync")
    out = serve(engine, SamplingParams, {"r": list(range(1, 40))}, 3)
    assert len(out["r"]) == 3
    engine.cleanup()
    fresh_metrics()


@pytest.mark.parametrize("name,expect", [
    ("fa_vattn_sync", "FA_VATTN_SYNC"), ("fa_vattn_2mb", "FA_VATTN"),
    ("fa_vattn_megacache_sync_64kb", "FA_VATTN_MEGACACHE_SYNC"),
    ("fa_pod_megacache", "FA_POD_MEGACACHE"),
    ("fi_serial_paged_16", "FI_SERIAL_PAGED")])
def test_backend_names_resolve_to_the_longest_match(name, expect):
    from vattention_tpu_torch.model_executor.attention import (
        AttentionBackend)

    assert AttentionBackend.resolve(name) is AttentionBackend[expect]


def test_dummy_weights_are_seeded_and_shaped():
    from vattention_tpu.config import get_model_arch as jax_arch
    from vattention_tpu.model_executor.models.llama import (
        LlamaForCausalLM as JaxLlama)
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.model_executor.models.llama import (
        LlamaForCausalLM)

    model = LlamaForCausalLM(get_model_arch("tiny-llama-debug"),
                             dtype=torch.float32)
    cpu = torch.device("cpu")
    p0, p1 = model.init_params(cpu, seed=0), model.init_params(cpu, seed=0)
    p2 = model.init_params(cpu, seed=1)
    assert torch.equal(p0["layers"]["qkv_w"], p1["layers"]["qkv_w"])
    assert not torch.equal(p0["layers"]["qkv_w"], p2["layers"]["qkv_w"])
    assert torch.equal(p0["final_norm"], torch.ones_like(p0["final_norm"]))
    assert abs(float(p0["lm_head"].std()) - 0.02) < 2e-3
    # the same tree of shapes as the JAX package: params_from_jax is a copy
    jax_params = JaxLlama(jax_arch("tiny-llama-debug")).init_params(
        np.random.default_rng(0), zero=True)
    ported = params_from_jax(jax.tree.map(np.asarray, jax_params))
    shapes = jax.tree.map(lambda x: tuple(x.shape), ported)
    expect = jax.tree.map(lambda x: tuple(x.shape), p0)
    assert shapes == expect
