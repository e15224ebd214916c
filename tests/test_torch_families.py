"""The qwen, qwen2 and internlm families in the PyTorch port, on the CPU.

Each family is the Llama body with a bias on the qkv projection
(``ModelArch.qkv_bias``).  A tiny config.json of each (tiny-llama-debug's
widths, the bias on) is written into a temporary directory; both packages
must read the same ``ModelArch`` from it and register the family.  The
JAX fa_vattn engine serves two prompts greedily with its weights' qkv
bias set to seeded nonzero values (the JAX init leaves it zero, which
would test nothing); the weights go through ``params_from_jax``, which
carries ``layers.qkv_b`` across, into the port's fa_vattn engine
(device="cpu"), whose greedy tokens must be the same.  float32 throughout,
as tests/test_torch_engine.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.config import get_model_arch as jax_arch
from vattention_tpu.model_executor.models import \
    get_model_class as jax_model_class
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.config import get_model_arch
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax

TINY = dict(num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=128, hidden_size=256,
            intermediate_size=688, vocab_size=2048,
            max_position_embeddings=8192)
FAMILIES = {
    "qwen": {},
    # a Qwen2 config.json names its bias; "qwen" and "internlm" imply it
    "qwen2": dict(attention_bias=True),
    "internlm": {},
}


def fresh_metrics():
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore as T

    J._instance = None
    T._instance = None


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


def write_config(tmp_path, family):
    path = tmp_path / family
    path.mkdir()
    (path / "config.json").write_text(json.dumps(
        {**TINY, "model_type": family, **FAMILIES[family]}))
    return str(path)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_json_gives_the_jax_arch(tmp_path, family):
    """The same ModelArch from the same config.json, qkv bias on and no
    window, and a registered model class (the llama body)."""
    model = write_config(tmp_path, family)
    arch = get_model_arch(model)
    assert dataclasses.asdict(arch) == dataclasses.asdict(jax_arch(model))
    assert arch.qkv_bias and arch.sliding_window is None
    assert get_model_class(family).__name__ == \
        jax_model_class(family).__name__


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_engine_matches_jax_engine(tmp_path, family):
    model = write_config(tmp_path, family)
    kw = dict(model=model, dtype="float32", attention_backend="fa_vattn",
              scheduler_type="sarathi", max_model_len=512, max_batch_size=4,
              max_num_seqs=4, chunk_size=128, gpu_memory_utilization=0.9)
    rng = np.random.default_rng(7)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([150, 37])}
    fresh_metrics()
    jax_engine = JaxLLMEngine.from_engine_args(**kw)
    runner = jax_engine.worker.model_runner
    np_params = jax.tree.map(np.asarray, runner.params)
    bias = np_params["layers"]["qkv_b"]
    assert not bias.any()
    np_params["layers"]["qkv_b"] = (
        rng.standard_normal(bias.shape) * 0.5).astype(bias.dtype)
    runner.params = jax.tree.map(jnp.asarray, np_params)
    expect = serve(jax_engine, JaxSamplingParams, prompts, 6)
    jax_engine.cleanup()

    fresh_metrics()
    engine = LLMEngine.from_engine_args(**kw, load_format="zero",
                                        device="cpu")
    params = params_from_jax(np_params)
    assert np.array_equal(params["layers"]["qkv_b"].numpy(),
                          np_params["layers"]["qkv_b"])
    engine.worker.model_runner.params = params
    got = serve(engine, SamplingParams, prompts, 6)
    assert got == expect
    engine.cleanup()
    fresh_metrics()
