"""Quantized-KV quality gate for the port: <= 0.1 perplexity delta.

The twin of tests/test_fp8_quality.py (BASELINE.md's "<=0.1 ppl delta with
FP8 KV cache").  The tiny llama is trained in JAX on that test's
structured synthetic corpus, as that test trains it, and carried into the
port with ``params_from_jax`` (the port does not load safetensors yet,
ROADMAP Queue 1 item 6); teacher-forced perplexity is then measured
through the port's serving layers -- kernel A's append (quantizing into
the arena) and kernel B's chunked prefill, through the vattn backend, on
CPU tensors (the plain versions) -- with a bf16, an e4m3 and an int8
(step 0.04) arena, and the two 1-byte arenas must stay within 0.1 of the
bf16 arena's perplexity.
"""

import jax
import numpy as np
import torch

from tests.test_fp8_quality import SEQ_LEN, make_corpus, train_tiny_model
from vattention_tpu_torch.config import get_model_arch
from vattention_tpu_torch.model_executor.attention.vattn_backend import (
    VattnAttentionBackend)
from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
from vattention_tpu_torch.model_executor.models import get_model_class
from vattention_tpu_torch.model_executor.step_inputs import StepInputs
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax
from vattention_tpu_torch.ops.utils import round_up, tile_rows_from_segments

ARCH = get_model_arch("tiny-llama-debug")
Q_TILE = 128
BLOCK = 256


def serving_ppl(model, params, tokens, kv_dtype, kv_scale=None):
    """One prefill pass of ``tokens`` through the vattn backend's append
    and prefill over an arena of ``kv_dtype``; perplexity over positions
    1..T-1."""
    a = model.arch
    T = len(tokens)
    n_pre = round_up(T, Q_TILE)
    R = round_up(n_pre, BLOCK) + BLOCK
    backend = VattnAttentionBackend(block_tokens=BLOCK, max_context_len=n_pre,
                                    arena_rows=R, q_tile=Q_TILE,
                                    kv_scale=kv_scale)
    Dp = round_up(a.head_dim, 128)
    kv_cache = torch.zeros((a.num_layers, 2, a.num_kv_heads, R, Dp),
                           dtype=kv_dtype)
    token_ids = np.zeros(n_pre, np.int64)
    token_ids[:T] = tokens
    rows = np.full(n_pre, -1, np.int32)
    rows[:T] = np.arange(T)
    seg_row = np.zeros((1, 8), np.int32)
    seg_cum = np.full((1, 9), R, np.int32)
    seg_cum[0, 0] = 0
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32))  # noqa: E731
    inputs = StepInputs(
        token_ids=torch.from_numpy(token_ids),
        positions=i32(np.arange(n_pre)),
        append_rows=i32(rows),
        dec_seqlens=i32(np.zeros(0)),
        dec_tile_rows=i32(np.zeros((0, backend.n_sub))),
        sample_idx=torch.zeros(0, dtype=torch.int64),
        temperatures=torch.zeros(0),
        top_p=torch.ones(0),
        top_k=i32(np.zeros(0)),
        pre_qinfo=i32([[0, T]]),
        qt_run=i32([[0, i] for i in range(n_pre // Q_TILE)]),
        pre_tile_rows=i32(tile_rows_from_segments(seg_row, seg_cum,
                                                  backend.sub,
                                                  backend.n_sub)))
    with torch.no_grad():
        x = model.embed(params, inputs.token_ids)
        x = model.run_layers(params, kv_cache, x, inputs, backend, n_pre)
        x = rms_norm(x, params["final_norm"], a.rms_norm_eps)
        head = (params["embed"].T if a.tie_word_embeddings
                else params["lm_head"])
        logits = x[:T].float() @ head.float()
    logp = torch.log_softmax(logits[:-1], dim=-1)
    tgt = torch.tensor(tokens[1:])
    nll = -logp.gather(1, tgt[:, None])[:, 0]
    return float(torch.exp(nll.mean()))


def test_quantized_kv_ppl_delta():
    rng = np.random.default_rng(0)
    _, jparams, train_loss, _ = train_tiny_model(rng)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    model = get_model_class(ARCH.model_type)(ARCH, dtype=torch.float32)
    eval_ids = make_corpus(np.random.default_rng(1234), 1,
                           SEQ_LEN)[0].tolist()
    ppl_bf16 = serving_ppl(model, params, eval_ids, torch.bfloat16)
    ppl_fp8 = serving_ppl(model, params, eval_ids, torch.float8_e4m3fn)
    ppl_int8 = serving_ppl(model, params, eval_ids, torch.int8,
                           kv_scale=0.04)
    # the model learned the chain (uniform over the used vocab is ~64)
    assert ppl_bf16 < 20.0, (ppl_bf16, train_loss)
    assert abs(ppl_fp8 - ppl_bf16) <= 0.1, (ppl_bf16, ppl_fp8)
    assert abs(ppl_int8 - ppl_bf16) <= 0.1, (ppl_bf16, ppl_int8)
