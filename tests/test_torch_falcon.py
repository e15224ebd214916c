"""Falcon (parallel attention, MQA at 71 query heads on 1 kv head) in the
PyTorch port, on the CPU, against the JAX package.

Layers: ``gelu_new`` and ``layer_norm`` against the JAX functions on the
same numpy-seeded inputs (float32 within 1e-6; bf16 within one bf16 step of
2^-7 relative, the two frameworks' tanh and rsqrt rounding apart).  The
model: a tiny falcon (71 query heads, 1 kv head, head dim 64, hidden 256)
through both packages' ``FalconForCausalLM.forward`` with their no_op
attention backends (attention is the rotated query, so the forward's
norms, projections, rope, parallel residual and head are what is
compared), float32 logits within 1e-5.

Kernels at G = 71: the port's plain versions of B, C, E and F against
``flash_prefill_multi``, ``flash_decode``, ``paged_flash_prefill_multi``
and ``pod_fused_attention`` in Pallas interpret mode (as
tests/test_kernels.py runs them), float32 within atol = rtol = 1e-4
(online against full softmax, summed in other orders), idle decode slots
exactly zero.

Engines: the tiny falcon as a ``config.json`` under ``tmp_path``, served
greedily by the JAX fa_vattn engine once (interpret mode at G = 71 is
slow, so the fixture runs one backend on short prompts); its weights go
through ``params_from_jax`` into the port's fa_vattn, fa_vattn_64kb (so
kernel D's relocation plans run), fa_paged_16 and fa_pod engines
(device="cpu"), which must give the same tokens.  Last, the config parse:
falcon-7b's own ``config.json`` states ``"multi_query": true`` and no
``num_key_value_heads``; the port reads one kv head, the JAX package
``num_attention_heads`` (ROADMAP Queue 3).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import fresh_metrics, serve

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu.config import ModelArch as JaxModelArch
from vattention_tpu.config import get_model_arch as jax_model_arch
from vattention_tpu.model_executor.attention.no_op_backend import \
    NoOpAttentionBackend as JaxNoOp
from vattention_tpu.model_executor.layers.activation import \
    gelu_new as jax_gelu_new
from vattention_tpu.model_executor.models import \
    get_model_class as jax_model_class
from vattention_tpu.model_executor.models.falcon import \
    layer_norm as jax_layer_norm
from vattention_tpu.ops import utils as jutils
from vattention_tpu.ops.flash_decode import flash_decode
from vattention_tpu.ops.flash_prefill import flash_prefill_multi
from vattention_tpu.ops.paged_attention import paged_flash_prefill_multi
from vattention_tpu.ops.pod_fused import (build_pod_schedule,
                                          pod_fused_attention)
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.config import ModelArch, get_model_arch
from vattention_tpu_torch.model_executor.attention.no_op_backend import \
    NoOpAttentionBackend
from vattention_tpu_torch.model_executor.layers.activation import gelu_new
from vattention_tpu_torch.model_executor.layers.layernorm import layer_norm
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.models.falcon import \
    FalconForCausalLM
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.flash_decode import decode_attention
from vattention_tpu_torch.ops.flash_prefill import prefill_attention
from vattention_tpu_torch.ops.paged_attention import paged_prefill_attention
from vattention_tpu_torch.ops.pod_fused import pod_attention

HQ, HKV = 71, 1            # falcon-7b's attention heads
D = 128                    # the arena's head dim (falcon's 64, padded)
L, R, S, SUB, PAD = 2, 1024, 8, 128, 128
TOL = 1e-4
SM = 64 ** -0.5


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
def test_gelu_new_matches_jax(dtype, tol):
    x = np.random.default_rng(0).standard_normal((64, 300)) * 3
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    expect = np.asarray(jax_gelu_new(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = gelu_new(t(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), expect, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
def test_layer_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 256)) * 4 + 1
    w = rng.standard_normal(256)
    b = rng.standard_normal(256)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    expect = np.asarray(jax_layer_norm(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        1e-5).astype(jnp.float32))
    got = layer_norm(t(x).to(dtype), t(w).to(dtype), t(b).to(dtype), 1e-5)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), expect, atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
TINY = dict(model_type="falcon", num_hidden_layers=2,
            num_attention_heads=HQ, num_key_value_heads=HKV, head_dim=64,
            hidden_size=256, intermediate_size=1024, vocab_size=2048,
            max_position_embeddings=2048, parallel_attn=True)


def tiny_arch(cls):
    return cls("falcon", num_layers=2, num_q_heads=HQ, num_kv_heads=HKV,
               head_dim=64, hidden_size=256, intermediate_size=1024,
               vocab_size=2048, max_position_embeddings=2048,
               parallel_attn=True)


def test_the_registry_serves_falcon():
    """falcon-7b and its long-context geometry resolve to the port's
    FalconForCausalLM; a llama body refuses a parallel-attention arch and
    the falcon body a sequential one."""
    for name in ("falcon-7b", "falcon-7b-32k-l8", "tiiuae/falcon-7b"):
        arch = get_model_arch(name)
        assert get_model_class(arch.model_type) is FalconForCausalLM
        assert (arch.num_q_heads, arch.num_kv_heads, arch.head_dim) == \
            (71, 1, 64)
    arch = tiny_arch(ModelArch)
    with pytest.raises(NotImplementedError, match="parallel_attn"):
        get_model_class("llama")(arch, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="parallel_attn"):
        FalconForCausalLM(get_model_arch("tiny-llama-debug"))


def test_falcon_params_have_the_jax_pytree():
    """The port's param names and shapes are the JAX model's, so
    params_from_jax carries them unchanged; init_params draws norms of
    ones, norm biases of zeros and N(0, 0.02^2) weights."""
    jmodel = jax_model_class("falcon")(tiny_arch(JaxModelArch),
                                       dtype=jnp.float32, tp_size=1)
    jp = jmodel.init_params(np.random.default_rng(0))
    model = FalconForCausalLM(tiny_arch(ModelArch), dtype=torch.float32)
    params = model.init_params(torch.device("cpu"), seed=0)

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in tree.items()}

    assert shapes(params) == shapes(jp)
    for name in ("input_norm", "input_norm_b"):
        assert torch.equal(params["layers"][name],
                           torch.full_like(params["layers"][name],
                                           float(name == "input_norm")))
    assert not params["final_norm_b"].any()
    assert 0.015 < float(params["layers"]["up_w"].std()) < 0.025


def test_tiny_falcon_forward_matches_jax():
    """Both packages' forward on the same weights and 37 tokens at
    positions 0..36, through their no_op attention backends; float32
    logits of 3 sampled rows within 1e-5."""
    jmodel = jax_model_class("falcon")(tiny_arch(JaxModelArch),
                                       dtype=jnp.float32, tp_size=1)
    jp = jmodel.init_params(np.random.default_rng(7))
    rng = np.random.default_rng(8)
    # non-trivial norms and biases
    lj = dict(jp["layers"])
    lj["input_norm"] = jnp.asarray(1 + 0.1 * rng.standard_normal(
        lj["input_norm"].shape), jnp.float32)
    lj["input_norm_b"] = jnp.asarray(0.1 * rng.standard_normal(
        lj["input_norm_b"].shape), jnp.float32)
    jp = dict(jp, layers=lj,
              final_norm_b=jnp.asarray(0.1 * rng.standard_normal(256),
                                       jnp.float32))
    T = 37
    ids = rng.integers(1, 2048, T).astype(np.int32)
    sample = np.array([0, 20, T - 1], np.int32)
    jin = types.SimpleNamespace(token_ids=jnp.asarray(ids),
                                positions=jnp.arange(T, dtype=jnp.int32),
                                sample_idx=jnp.asarray(sample))
    _, expect = jmodel.forward(jp, jnp.zeros((L, 2, HKV, 8, 64)), jin,
                               JaxNoOp(), T)

    model = FalconForCausalLM(tiny_arch(ModelArch), dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    pin = types.SimpleNamespace(token_ids=t(ids).long(),
                                positions=torch.arange(T, dtype=torch.int32),
                                sample_idx=t(sample))
    got = model.forward(params, torch.zeros((L, 2, HKV, 8, 64)), pin,
                        NoOpAttentionBackend(), T)
    assert got.dtype == torch.float32 and got.shape == (3, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------- #
# kernels at G = 71: the plain versions against the JAX kernels
# ---------------------------------------------------------------------- #
# (extents, q_start, chunk): a chunk off the 64-key tile edges over two
# extents (aligned to the JAX kernel's kv tile), a first chunk, then the
# empty run
RUNS = [([(0, 256), (512, 128)], 200, 120),
        ([(768, 64)], 0, 60),
        ([], 0, 0)]


def seg_tables(extents_per_seq):
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


def prefill_case(seed):
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


def test_prefill_b_at_g71_matches_flash_prefill_multi():
    cache, q, seg_row, seg_cum, qinfo, qt_run, tile_rows, real = \
        prefill_case(1)
    expect = np.asarray(flash_prefill_multi(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(seg_row),
        jnp.asarray(seg_cum), jnp.asarray(qinfo), jnp.asarray(qt_run),
        jnp.asarray([1], jnp.int32), jnp.asarray(tile_rows), q_tile=PAD,
        kv_tile=SUB, num_segments=S, max_kv_tiles=R // SUB, sm_scale=SM))
    got = prefill_attention(t(q), t(cache), t(qt_run), t(qinfo),
                            t(tile_rows), 1, sub=SUB, pad_tile=PAD,
                            sm_scale=SM).numpy()
    for lo, hi in real:
        np.testing.assert_allclose(got[lo:hi], expect[lo:hi], atol=TOL,
                                   rtol=TOL)
    assert not got[real[-1][0]:].any()   # the empty run's tile


def test_paged_prefill_e_at_g71_matches_paged_flash_prefill_multi():
    """E over 16-token blocks naming B's rows, a table tail past each
    run's last valid block poisoned on the port's side (the kernel never
    reads it)."""
    cache, q, seg_row, seg_cum, qinfo, qt_run, _, real = prefill_case(2)
    bs, nb = 16, 24
    tables = np.zeros((len(RUNS), nb), np.int32)
    for r, (ext, q0, c) in enumerate(RUNS):
        rows = np.concatenate([np.arange(row, row + n) for row, n in ext]
                              or [np.zeros(0, np.int64)])
        tables[r, :len(rows[::bs])] = rows[::bs] // bs
    expect = np.asarray(paged_flash_prefill_multi(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
        jnp.asarray(qinfo), jnp.asarray(qt_run), jnp.asarray([1], jnp.int32),
        q_tile=PAD, block_size=bs, sm_scale=SM))
    poisoned = tables.copy()
    for r, (_, q0, c) in enumerate(RUNS):
        poisoned[r, -(-(q0 + c) // bs):] = 2 ** 30
    got = paged_prefill_attention(t(q), t(cache), t(qt_run), t(qinfo),
                                  t(poisoned), 1, block_size=bs,
                                  pad_tile=PAD, sm_scale=SM).numpy()
    for lo, hi in real:
        np.testing.assert_allclose(got[lo:hi], expect[lo:hi], atol=TOL,
                                   rtol=TOL)


def decode_case(seed, depths):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    n_sub = R // SUB
    tile_rows = np.stack([rng.permutation(R // SUB)[:n_sub] * SUB
                          for _ in depths]).astype(np.int32)
    q = rng.standard_normal((len(depths), HQ, D)).astype(np.float32)
    return cache, q, tile_rows, np.asarray(depths, np.int32)


def test_decode_c_at_g71_matches_flash_decode():
    depths = [1, 64, 65, 0, 700]
    cache, q, tile_rows, seqlens = decode_case(3, depths)
    expect = np.asarray(flash_decode(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tile_rows),
        jnp.asarray(seqlens), jnp.ones(1, jnp.int32), kv_tile=SUB,
        max_kv_tiles=R // SUB, sm_scale=SM))
    got = decode_attention(t(q), t(cache), t(tile_rows), t(seqlens), 1,
                           sub=SUB, sm_scale=SM).numpy()
    np.testing.assert_allclose(got, expect, atol=TOL, rtol=TOL)
    assert not got[3].any() and np.isfinite(got).all()


def test_pod_f_at_g71_matches_pod_fused_attention():
    """One run (chunk 128 at depth 448 over two extents) and 3 slots, one
    idle."""
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((L, 2, HKV, R, D)).astype(np.float32)
    pre_row, pre_cum = seg_tables([[(0, 256), (512, 192)]])
    qinfo = np.array([[320, 448]], np.int32)
    qp = rng.standard_normal((128, HQ, D)).astype(np.float32)
    dec_row, dec_cum = seg_tables([[(256, 256)], [(768, 128)], []])
    seqlens = np.array([250, 100, 0], np.int32)
    qd = rng.standard_normal((3, HQ, D)).astype(np.float32)
    sched = build_pod_schedule([128], PAD, SUB, qinfo, seqlens)
    op, od = pod_fused_attention(
        jnp.asarray(qp), jnp.asarray(qd), jnp.asarray(cache),
        jnp.asarray(sched), jnp.asarray(pre_row), jnp.asarray(pre_cum),
        jnp.asarray(qinfo), jnp.ones(1, jnp.int32), jnp.asarray(dec_row),
        jnp.asarray(dec_cum), jnp.asarray(seqlens), q_tile=PAD, kv_tile=SUB,
        num_segments=S, sm_scale=SM)
    n_sub = R // SUB
    gp, gd = pod_attention(
        t(qp), t(qd), t(cache), torch.tensor([[0, 0]], dtype=torch.int32),
        t(qinfo), t(jutils.tile_rows_from_segments(pre_row, pre_cum, SUB,
                                                   n_sub)),
        t(jutils.tile_rows_from_segments(dec_row, dec_cum, SUB, n_sub)),
        t(seqlens), 1, sub=SUB, pad_tile=PAD, sm_scale=SM)
    np.testing.assert_allclose(gp.numpy(), np.asarray(op), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(od), atol=TOL,
                               rtol=TOL)
    assert not gd[2].any()


# ---------------------------------------------------------------------- #
# engines
# ---------------------------------------------------------------------- #
PROMPT_LENS = [150, 40]
MAX_TOKENS = 4


def write_config(path, **cfg):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def engine_args(model, backend):
    return dict(model=model, dtype="float32", attention_backend=backend,
                scheduler_type="sarathi", max_model_len=512,
                max_batch_size=4, max_num_seqs=4, chunk_size=128,
                gpu_memory_utilization=0.9)


@pytest.fixture(scope="module")
def falcon_run(tmp_path_factory):
    """(model dir, prompts, the JAX fa_vattn engine's tokens, its weights
    as numpy)."""
    fresh_metrics()
    model = write_config(tmp_path_factory.mktemp("falcon"), **TINY)
    rng = np.random.default_rng(11)
    prompts = {f"r{i}": rng.integers(1, 2048, n).tolist()
               for i, n in enumerate(PROMPT_LENS)}
    engine = JaxLLMEngine.from_engine_args(**engine_args(model, "fa_vattn"))
    expect = serve(engine, JaxSamplingParams, prompts, MAX_TOKENS)
    np_params = jax.tree.map(np.asarray, engine.worker.model_runner.params)
    engine.cleanup()
    fresh_metrics()
    return model, prompts, expect, np_params


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_vattn_64kb",
                                     "fa_paged_16", "fa_pod"])
def test_port_engines_match_the_jax_falcon_engine(falcon_run, backend):
    model, prompts, expect, np_params = falcon_run
    fresh_metrics()
    engine = LLMEngine.from_engine_args(**engine_args(model, backend),
                                        load_format="zero", device="cpu")
    runner = engine.worker.model_runner
    assert isinstance(runner.model, FalconForCausalLM)
    assert (runner.model.hq, runner.model.hkv) == (HQ, HKV)
    kv = runner.cache_engine.kv_cache
    assert (kv.shape[2], kv.shape[-1]) == (HKV, D)   # head dim 64 padded
    runner.params = params_from_jax(np_params)
    got = serve(engine, SamplingParams, prompts, MAX_TOKENS)
    assert got == expect
    if backend == "fa_pod":
        assert runner.backend.pod_steps > 0
    engine.cleanup()
    fresh_metrics()


# ---------------------------------------------------------------------- #
# falcon-7b's config.json
# ---------------------------------------------------------------------- #
FALCON_7B_CONFIG = {   # tiiuae/falcon-7b's config.json, its model fields
    "model_type": "falcon", "hidden_size": 4544, "num_attention_heads": 71,
    "num_hidden_layers": 32, "multi_query": True, "parallel_attn": True,
    "vocab_size": 65024, "layer_norm_epsilon": 1e-5, "bias": False,
    "alibi": False, "new_decoder_architecture": False}


def test_multi_query_parse_in_both_packages(tmp_path):
    """The port reads ``multi_query: true`` as one kv head, so the
    checkpoint's fused qkv of (71 + 2) * 64 rows fits; the JAX package
    reads ``num_attention_heads`` kv heads (the divergence of ROADMAP
    Queue 3).  An explicit ``num_key_value_heads`` wins in both."""
    path = write_config(tmp_path / "falcon-7b", **FALCON_7B_CONFIG)
    port, jx = get_model_arch(path), jax_model_arch(path)
    assert (port.num_q_heads, port.num_kv_heads, port.head_dim) == (71, 1, 64)
    assert (jx.num_q_heads, jx.num_kv_heads) == (71, 71)
    assert port.parallel_attn and jx.parallel_attn
    assert (port.q_dim + 2 * port.kv_dim) == 4672
    explicit = write_config(tmp_path / "explicit",
                            **FALCON_7B_CONFIG, num_key_value_heads=1)
    assert get_model_arch(explicit).num_kv_heads == 1
    assert jax_model_arch(explicit).num_kv_heads == 1
    assert get_model_arch(write_config(
        tmp_path / "mha", **dict(FALCON_7B_CONFIG, multi_query=False))
    ).num_kv_heads == 71


def test_falcon_checkpoint_round_trip(tmp_path):
    """``microbenchmarks/checkpoint.py`` writes a falcon model in falcon's
    own layout (``transformer.h.*``; a config.json with ``multi_query`` and
    no ``head_dim``, as tiiuae/falcon-7b's), which reads back as the same
    architecture and loads bit for bit (chip_smoke (k long) at full
    width)."""
    from vattention_tpu_torch.microbenchmarks.checkpoint import hf_config
    from vattention_tpu_torch.microbenchmarks.server_phase import round_trip

    arch = ModelArch("falcon", num_layers=2, num_q_heads=4, num_kv_heads=1,
                     head_dim=64, hidden_size=256, intermediate_size=1024,
                     vocab_size=512, max_position_embeddings=2048,
                     rope_theta=1e6, parallel_attn=True)
    cfg = hf_config(arch)
    assert cfg["multi_query"] and "head_dim" not in cfg
    model = FalconForCausalLM(arch, dtype=torch.bfloat16)
    res = round_trip(model, torch.device("cpu"), tmp_path, seed=3)
    assert res["tensors"] == 10 and res["hf_tensors"] == 2 * 6 + 4
    assert get_model_arch(str(tmp_path)) == arch


def test_falcon_op_rows(tmp_path):
    """The op profiler times falcon's own layer: its ungated GELU MLP and
    biased LayerNorm, and the attention rows at 71 query heads."""
    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model=write_config(tmp_path / "falcon", **TINY), dtype="float32",
        max_model_len=512, max_batch_size=2, device="cpu")
    ops = engine.worker.profile_op_level(ctx=200, iters=1)
    assert all(ops[k] > 0 for k in (
        "attn_prefill", "attn_decode", "attn_kv_cache_save", "mlp_up_proj",
        "mlp_activation", "mlp_down_proj", "input_layernorm")), ops
    engine.cleanup()
    fresh_metrics()
