"""Local safetensors checkpoints in the PyTorch port, against the JAX loader.

A tiny HF-layout checkpoint (tiny-llama-debug's widths, seeded numpy
weights, one file per layer plus one for the embeddings and head, and a
config.json) is written into ``tmp_path``.  The port's ``load_safetensors``
must place every tensor where the JAX loader does (q/k/v and gate/up
concatenated, projections transposed to [in, out]), equal after
``params_from_jax`` of the JAX side, bit for bit: float32 throughout, so
both packages read the same checkpoint.  Both engines, loading that one
checkpoint, must give the same greedy tokens.  The qkv-bias family
(qwen2) and tied embeddings load too; a bf16 checkpoint, which the JAX
loader's numpy reader cannot read, loads bit for bit into a bf16 model;
falcon's layout raises naming ROADMAP item 12.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.config import ModelConfig as JaxModelConfig
from vattention_tpu.model_executor.models import \
    get_model_class as jax_model_class
from vattention_tpu.model_executor.weight_utils import \
    load_weights as jax_load_weights
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.config import ModelConfig, get_model_arch
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.weight_utils import (
    load_safetensors, load_weights, params_from_jax)

from test_torch_engine import fresh_metrics, serve

TINY = dict(num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=128, hidden_size=256,
            intermediate_size=688, vocab_size=2048,
            max_position_embeddings=8192)
# config.json fields beside TINY's
CASES = {
    "llama": dict(model_type="llama"),
    # Qwen2 names its qkv bias in config.json
    "qwen2": dict(model_type="qwen2", attention_bias=True),
    "tied": dict(model_type="llama", tie_word_embeddings=True),
}


@pytest.fixture(autouse=True)
def _fresh_metrics():
    fresh_metrics()
    yield
    fresh_metrics()


def hf_tensors(cfg, rng, dtype=np.float32):
    """{file name: {HF name: array}} of a seeded llama-family checkpoint."""
    H, D = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    inter, V = cfg["intermediate_size"], cfg["vocab_size"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(dtype)

    files = {}
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        t = {p + "self_attn.q_proj.weight": w(hq * D, H),
             p + "self_attn.k_proj.weight": w(hkv * D, H),
             p + "self_attn.v_proj.weight": w(hkv * D, H),
             p + "self_attn.o_proj.weight": w(H, hq * D),
             p + "mlp.gate_proj.weight": w(inter, H),
             p + "mlp.up_proj.weight": w(inter, H),
             p + "mlp.down_proj.weight": w(H, inter),
             p + "input_layernorm.weight": 1 + w(H),
             p + "post_attention_layernorm.weight": 1 + w(H)}
        if cfg.get("attention_bias"):
            t.update({p + "self_attn.q_proj.bias": w(hq * D),
                      p + "self_attn.k_proj.bias": w(hkv * D),
                      p + "self_attn.v_proj.bias": w(hkv * D)})
        files[f"model-layer{l:02d}.safetensors"] = t
    top = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": 1 + w(H)}
    if not cfg.get("tie_word_embeddings"):
        top["lm_head.weight"] = w(V, H)
    files["model-top.safetensors"] = top
    return files


def write_checkpoint(path, case="llama", seed=0):
    """A float32 checkpoint of ``case`` in ``path``; returns its tensors
    by HF name."""
    path.mkdir(parents=True, exist_ok=True)
    cfg = {**TINY, **CASES[case]}
    (path / "config.json").write_text(json.dumps(cfg))
    raw = {}
    for name, tensors in hf_tensors(cfg, np.random.default_rng(seed)).items():
        save_file(tensors, str(path / name))
        raw.update(tensors)
    return raw


def port_load(path, dtype=torch.float32):
    cfg = ModelConfig(model=str(path), load_format="safetensors",
                      dtype={torch.float32: "float32",
                             torch.bfloat16: "bfloat16"}[dtype])
    model = get_model_class(cfg.arch.model_type)(cfg.arch, dtype=dtype)
    return model, load_weights(model, cfg, torch.device("cpu"))


def jax_load(path):
    cfg = JaxModelConfig(model=str(path), load_format="safetensors",
                         dtype="float32")
    model = jax_model_class(cfg.arch.model_type)(cfg.arch,
                                                 dtype=jnp.float32, tp_size=1)
    return jax.tree.map(np.asarray, jax_load_weights(model, cfg))


def test_safetensors_single_rank(tmp_path):
    """Each HF tensor lands in its place: q/k/v concatenated and
    transposed, gate/up fused, o/down/lm_head transposed; bit for bit."""
    raw = write_checkpoint(tmp_path)
    _, params = port_load(tmp_path)
    lp = params["layers"]
    for l in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{l}."
        qkv = np.concatenate([raw[p + f"self_attn.{x}_proj.weight"]
                              for x in "qkv"], axis=0).T
        np.testing.assert_array_equal(lp["qkv_w"][l].numpy(), qkv)
        gate_up = np.concatenate([raw[p + "mlp.gate_proj.weight"],
                                  raw[p + "mlp.up_proj.weight"]], axis=0).T
        np.testing.assert_array_equal(lp["gate_up_w"][l].numpy(), gate_up)
        np.testing.assert_array_equal(lp["o_w"][l].numpy(),
                                      raw[p + "self_attn.o_proj.weight"].T)
        np.testing.assert_array_equal(lp["down_w"][l].numpy(),
                                      raw[p + "mlp.down_proj.weight"].T)
        np.testing.assert_array_equal(lp["input_norm"][l].numpy(),
                                      raw[p + "input_layernorm.weight"])
        np.testing.assert_array_equal(
            lp["post_norm"][l].numpy(),
            raw[p + "post_attention_layernorm.weight"])
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  raw["model.embed_tokens.weight"])
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  raw["model.norm.weight"])
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  raw["lm_head.weight"].T)


@pytest.mark.parametrize("case", list(CASES))
def test_port_loader_equals_the_jax_loader(tmp_path, case):
    """One float32 checkpoint through both loaders: the same params, bit
    for bit, after params_from_jax of the JAX side (qwen2's qkv bias
    included, no lm_head under tied embeddings)."""
    write_checkpoint(tmp_path, case, seed=1)
    _, got = port_load(tmp_path)
    expect = params_from_jax(jax_load(tmp_path))

    def flat(params):
        return {**{k: v for k, v in params.items() if k != "layers"},
                **{f"layers.{k}": v for k, v in params["layers"].items()}}

    got, expect = flat(got), flat(expect)
    assert sorted(got) == sorted(expect)
    assert ("layers.qkv_b" in got) == (case == "qwen2")
    assert ("lm_head" in got) == (case != "tied")
    for name in expect:
        assert torch.equal(got[name], expect[name]), name


def test_engine_runs_with_safetensors_weights(tmp_path):
    """The port's engine serves a safetensors directory: greedy tokens of
    the loaded weights, the same as with those weights injected."""
    write_checkpoint(tmp_path, seed=2)
    kw = dict(model=str(tmp_path), dtype="float32",
              attention_backend="fa_vattn", scheduler_type="sarathi",
              max_model_len=256, max_batch_size=2, max_num_seqs=2,
              chunk_size=128, device="cpu")
    toks = np.random.default_rng(2).integers(1, 2000, 50).tolist()
    engine = LLMEngine.from_engine_args(**kw, load_format="safetensors")
    out = serve(engine, SamplingParams, {"w": toks}, 4)
    engine.cleanup()
    assert len(out["w"]) == 4

    fresh_metrics()
    engine = LLMEngine.from_engine_args(**kw, load_format="zero")
    engine.worker.model_runner.params = port_load(tmp_path)[1]
    assert serve(engine, SamplingParams, {"w": toks}, 4) == out
    engine.cleanup()


def test_port_and_jax_engines_serve_one_checkpoint_alike(tmp_path):
    """Both engines load one checkpoint directory (load_format
    safetensors) and give the same greedy tokens."""
    write_checkpoint(tmp_path, "qwen2", seed=3)
    kw = dict(model=str(tmp_path), dtype="float32", load_format="safetensors",
              attention_backend="fa_vattn", scheduler_type="sarathi",
              max_model_len=512, max_batch_size=4, max_num_seqs=4,
              chunk_size=128, gpu_memory_utilization=0.9)
    rng = np.random.default_rng(3)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([150, 37])}
    jax_engine = JaxLLMEngine.from_engine_args(**kw)
    expect = serve(jax_engine, JaxSamplingParams, prompts, 6)
    jax_engine.cleanup()

    fresh_metrics()
    engine = LLMEngine.from_engine_args(**kw, device="cpu")
    assert serve(engine, SamplingParams, prompts, 6) == expect
    engine.cleanup()


def test_bf16_checkpoint_loads_bit_for_bit(tmp_path):
    """A bf16 checkpoint (framework="pt" reads it; numpy has no bf16) lands
    in a bf16 model unchanged."""
    cfg = {**TINY, **CASES["llama"]}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    raw = {}
    for name, tensors in hf_tensors(cfg, np.random.default_rng(4)).items():
        tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
                   for k, v in tensors.items()}
        save_torch_file(tensors, str(tmp_path / name))
        raw.update(tensors)
    _, params = port_load(tmp_path, torch.bfloat16)
    assert params["embed"].dtype == torch.bfloat16
    assert torch.equal(params["layers"]["qkv_w"][1][:, :512],
                       raw["model.layers.1.self_attn.q_proj.weight"].T)
    assert torch.equal(params["layers"]["down_w"][0],
                       raw["model.layers.0.mlp.down_proj.weight"].T)
    assert torch.equal(params["lm_head"], raw["lm_head.weight"].T)


def test_a_missing_tensor_raises(tmp_path):
    write_checkpoint(tmp_path)
    (tmp_path / "model-layer01.safetensors").unlink()
    with pytest.raises(KeyError, match="model.layers.1."):
        port_load(tmp_path)


def write_falcon_checkpoint(path):
    """Falcon's fused-MQA layout (transformer.h.*), as the JAX package's
    test of it writes it."""
    path.mkdir(parents=True, exist_ok=True)
    H, D, hq, L, inter, V = 256, 64, 4, 2, 1024, 512
    (path / "config.json").write_text(json.dumps({
        "model_type": "falcon", "num_hidden_layers": L,
        "num_attention_heads": hq, "num_key_value_heads": 1,
        "head_dim": D, "hidden_size": H, "intermediate_size": inter,
        "vocab_size": V, "max_position_embeddings": 2048,
        "parallel_attn": True}))
    rng = np.random.default_rng(4)
    raw = {}
    for l in range(L):
        p = f"transformer.h.{l}."
        raw[p + "self_attention.query_key_value.weight"] = \
            rng.standard_normal(((hq + 2) * D, H)).astype(np.float32)
        raw[p + "self_attention.dense.weight"] = rng.standard_normal(
            (H, hq * D)).astype(np.float32)
        raw[p + "input_layernorm.weight"] = np.ones(H, np.float32)
    raw["transformer.word_embeddings.weight"] = rng.standard_normal(
        (V, H)).astype(np.float32)
    save_file(raw, str(path / "model.safetensors"))


@pytest.mark.parametrize("through", ["engine", "loader"])
def test_safetensors_falcon_layout_raises(tmp_path, through):
    """Falcon is ROADMAP item 12: its config.json stops the engine, and its
    tensor names stop the loader whatever the model."""
    write_falcon_checkpoint(tmp_path / "falcon")
    if through == "engine":
        with pytest.raises(NotImplementedError, match="item 12"):
            LLMEngine.from_engine_args(
                model=str(tmp_path / "falcon"), load_format="safetensors",
                dtype="float32", device="cpu", max_model_len=256)
        return
    arch = get_model_arch("tiny-llama-debug")
    model = get_model_class("llama")(arch, dtype=torch.float32)
    cfg = ModelConfig(model=str(tmp_path / "falcon"),
                      load_format="safetensors", dtype="float32", arch=arch)
    with pytest.raises(NotImplementedError, match="item 12"):
        load_safetensors(model, cfg, torch.device("cpu"))
