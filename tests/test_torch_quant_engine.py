"""The port's engine on quantized arenas against the JAX engine, on the CPU.

``kv_quant="fp8"`` (an e4m3 arena) and ``"int8"`` (an int8 arena in steps
of ``KV_INT8_SCALE``, default 0.04) on ``fa_vattn``, ``fa_paged_16`` and
``fa_pod``: the JAX engine serves tests/test_e2e.py's
``test_fp8_kv_cache_engine_path`` workload (rng 11, a 100-token prompt, 6
greedy tokens), its weights go through ``params_from_jax`` into the port's
engine (device="cpu": every kernel takes its plain version, kernel A's
quantizing as the JAX backend does), which must give the same tokens.
float32 model, as tests/test_torch_engine.py.  One request never mixes
prefill and decode in a step, so ``fa_pod`` serves it through B and C;
kernel F on 1-byte arenas is held in tests/test_torch_quant.py.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_engine import fresh_metrics, serve
from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax

ARENA = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_paged_16", "fa_pod"])
@pytest.mark.parametrize("kv_quant", ["fp8", "int8"])
def test_quantized_engine_matches_jax_engine(kv_quant, backend):
    fresh_metrics()
    kw = dict(model="tiny-llama-debug", dtype="float32",
              attention_backend=backend, scheduler_type="sarathi",
              max_model_len=512, max_batch_size=4, max_num_seqs=4,
              chunk_size=128, gpu_memory_utilization=0.9, kv_quant=kv_quant)
    rng = np.random.default_rng(11)
    prompts = {"q": rng.integers(1, 2000, 100).tolist()}
    jax_engine = JaxLLMEngine.from_engine_args(**kw)
    expect = serve(jax_engine, JaxSamplingParams, prompts, 6)
    np_params = jax.tree.map(np.asarray,
                             jax_engine.worker.model_runner.params)
    jax_ce = jax_engine.worker.cache_engine
    jax_geometry = (jax_ce.block_tokens, jax_ce.kv_scale)
    jax_engine.cleanup()

    engine = LLMEngine.from_engine_args(**kw, load_format="zero",
                                        device="cpu")
    ce = engine.worker.cache_engine
    assert ce.kv_cache.dtype == ARENA[kv_quant]
    assert (ce.block_tokens, ce.kv_scale) == jax_geometry
    engine.worker.model_runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, prompts, 6)
    assert got == expect
    engine.cleanup()
    fresh_metrics()


def test_one_byte_arena_holds_twice_the_tokens_per_page():
    """The allocator sizes blocks by the arena's element size: a 2 MB page
    of a 1-byte arena holds twice a bf16 arena's tokens."""
    def block_tokens(kv_quant):
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            model="tiny-llama-debug", dtype="bfloat16",
            attention_backend="fa_vattn_2mb", max_model_len=512,
            max_batch_size=2, gpu_memory_utilization=0.05, device="cpu",
            kv_quant=kv_quant)
        n = engine.worker.cache_engine.block_tokens
        engine.cleanup()
        return n

    bf16 = block_tokens("none")
    assert block_tokens("fp8") == block_tokens("int8") == 2 * bf16
    fresh_metrics()
