"""Per-operation timing (OperationMetrics producer).

Counterpart of ``vattention_tpu/metrics/op_profiler.py``.  The serving
step runs as one CUDA graph, so there is no place inside it to record an
event between ops.  As in the JAX package, each op category is measured
on its own at the model's serving shapes (its weights, arena and batch),
N calls in a row on the stream, feeding the ``OperationMetrics`` rows of
summary.json.  On a CUDA device the time is CUDA events around the N
calls over N; on the CPU, ``time.perf_counter`` around them (host time of
the plain versions: no device metric).

The norm and activation rows run the kernels the layer runs
(``ops/norm_act.py``): INPUT_LAYERNORM one residual add + norm of the
decode batch (``add_rms_norm``; falcon's ``add_layer_norm`` of x + (o +
mlp)), MLP_ACTIVATION ``silu_and_mul`` (falcon's ``gelu_new``).

The attention rows run the port's own kernels: ATTN_PREFILL one 256-token
chunk over ``ctx`` history through kernel B (kernel E on the paged pool),
ATTN_DECODE the batch at depth ``ctx`` through kernel C, and
ATTN_KV_CACHE_SAVE the batch's decode tokens through kernel A, which
rotates Q and K and writes K/V in one launch.  The JAX step's rope and
append are two ops with two rows, ATTN_ROPE and ATTN_KV_CACHE_SAVE; here
the rotation has no launch of its own, so the whole of kernel A is the
KV-save row and ATTN_ROPE is not recorded: no work is counted twice.  The
arena rows kernel A writes are put back afterwards.  Run via
``BaseWorker.profile_op_level()``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from vattention_tpu_torch.metrics.constants import OperationMetrics
from vattention_tpu_torch.metrics.metrics_store import MetricsStore


def _time(fn: Callable[[], object], iters: int,
          device: torch.device) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls in a row, after one
    call that builds and allocates."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def profile_operations(runner, *, ctx: int = 1024,
                       iters: int = 8) -> Dict[str, float]:
    """Time each op category at the runner's serving shapes and push the
    times into the MetricsStore.  Returns {op_name: seconds}."""
    from vattention_tpu_torch.model_executor.attention.no_op_backend import (
        NoOpAttentionBackend)
    from vattention_tpu_torch.model_executor.attention.paged_backend import (
        PagedAttentionBackend)
    from vattention_tpu_torch.model_executor.layers.sampler import (
        GREEDY, sample_tokens)
    from vattention_tpu_torch.model_executor.models.falcon import LN_EPS
    from vattention_tpu_torch.ops.cache_append import rope_kv_append
    from vattention_tpu_torch.ops.flash_decode import decode_attention
    from vattention_tpu_torch.ops.flash_prefill import prefill_attention
    from vattention_tpu_torch.ops.norm_act import (add_layer_norm,
                                                   add_rms_norm, gelu_new,
                                                   silu_and_mul)
    from vattention_tpu_torch.ops.paged_attention import (
        paged_prefill_attention)
    from vattention_tpu_torch.ops.utils import cdiv, round_up

    model, backend = runner.model, runner.backend
    arch = model.arch
    dev = runner.device
    store = MetricsStore.get_instance()
    B, D, Hq, Hkv = runner.B, model.head_dim, model.hq, model.hkv
    lp = {k: v[0] for k, v in runner.params["layers"].items()}
    kv_cache = runner.cache_engine.kv_cache
    Dp, R = kv_cache.shape[-1], kv_cache.shape[3]
    ctx = min(ctx, runner.config.model_config.max_model_len)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=model.dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    results: Dict[str, float] = {}

    def rec(op: OperationMetrics, fn) -> None:
        results[op.value] = seconds = _time(fn, iters, dev)
        store.push_operation_time(op, seconds)

    # projections, MLP and norm of one layer at the decode batch (falcon:
    # an ungated GELU MLP and a LayerNorm with a bias); the norm adds its
    # residual as the layer does
    x = randn(B, arch.hidden_size)
    r = randn(B, arch.hidden_size)
    up_w = lp["up_w"] if model.parallel_attn else lp["gate_up_w"]
    activation = gelu_new if model.parallel_attn else silu_and_mul
    up = randn(B, up_w.shape[1])
    act = activation(up)
    attn = randn(B, Hq * D)
    rec(OperationMetrics.ATTN_PRE_PROJ, lambda: x @ lp["qkv_w"])
    rec(OperationMetrics.ATTN_POST_PROJ, lambda: attn @ lp["o_w"])
    rec(OperationMetrics.MLP_UP_PROJ, lambda: x @ up_w)
    rec(OperationMetrics.MLP_ACTIVATION, lambda: activation(up))
    rec(OperationMetrics.MLP_DOWN_PROJ, lambda: act @ lp["down_w"])
    if model.parallel_attn:
        rec(OperationMetrics.INPUT_LAYERNORM,
            lambda: add_layer_norm(x, r, r, lp["input_norm"],
                                   lp["input_norm_b"], LN_EPS))
    else:
        rec(OperationMetrics.INPUT_LAYERNORM,
            lambda: add_rms_norm(x, r, lp["input_norm"], arch.rms_norm_eps))

    if not isinstance(backend, NoOpAttentionBackend):
        # kernel A at the decode batch, positions at ctx - 1; the rows it
        # writes are restored afterwards
        qkv = randn(B, (Hq + 2 * Hkv) * D)
        positions = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        saved = kv_cache[0, :, :, rows.long()].clone()
        rec(OperationMetrics.ATTN_KV_CACHE_SAVE,
            lambda: rope_kv_append(kv_cache, qkv, positions, rows, 0,
                                   model.rope, kv_scale=backend.kv_scale))
        kv_cache[0, :, :, rows.long()] = saved

        paged = isinstance(backend, PagedAttentionBackend)
        sub = backend.block_size if paged else backend.sub
        sm_scale = backend._eff_sm_scale(model.sm_scale)
        n_sub = cdiv(ctx, sub)
        span = n_sub * sub
        # each slot's history: ``span`` contiguous rows
        base = (np.arange(B) * span) % max(R - span, 1) // sub * sub
        tile_rows = torch.from_numpy(
            (base[:, None] + np.arange(n_sub) * sub).astype(np.int32)
        ).to(dev)
        seqlens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        q = randn(B, Hq, Dp)
        rec(OperationMetrics.ATTN_DECODE,
            lambda: decode_attention(q, kv_cache, tile_rows, seqlens, 0,
                                     sub=sub, sm_scale=sm_scale,
                                     window=backend.window))

        # one chunk of 256 query tokens (at most ctx) over ctx history
        Tq = round_up(min(256, ctx), backend.q_tile)
        qp = randn(Tq, Hq, Dp)
        K = runner.max_prefills
        qinfo = torch.zeros((K + 1, 2), dtype=torch.int32)
        qinfo[0] = torch.tensor([max(ctx - Tq, 0), ctx])
        qt_run = torch.zeros((Tq // backend.q_tile, 2), dtype=torch.int32)
        qt_run[:, 1] = torch.arange(Tq // backend.q_tile)
        table = torch.zeros((K + 1, n_sub), dtype=torch.int32)
        table[0] = torch.arange(n_sub) * (1 if paged else sub)
        qinfo, qt_run, table = qinfo.to(dev), qt_run.to(dev), table.to(dev)
        if paged:
            rec(OperationMetrics.ATTN_PREFILL,
                lambda: paged_prefill_attention(
                    qp, kv_cache, qt_run, qinfo, table, 0, block_size=sub,
                    pad_tile=backend.q_tile, sm_scale=sm_scale,
                    window=backend.window))
        else:
            rec(OperationMetrics.ATTN_PREFILL,
                lambda: prefill_attention(
                    qp, kv_cache, qt_run, qinfo, table, 0, sub=sub,
                    pad_tile=backend.q_tile, sm_scale=sm_scale,
                    window=backend.window))

    # lm head and sampler
    head = (runner.params["embed"].T if arch.tie_word_embeddings
            else runner.params["lm_head"])
    if x.is_cuda and x.dtype == torch.bfloat16:
        rec(OperationMetrics.LM_HEAD_LINEAR,
            lambda: torch.mm(x, head, out_dtype=torch.float32))
    else:
        rec(OperationMetrics.LM_HEAD_LINEAR, lambda: x.float() @ head.float())
    logits = randn(B, arch.vocab_size, dtype=torch.float32)
    temps = torch.zeros(B, device=dev)
    top_p = torch.ones(B, device=dev)
    top_k = torch.full((B,), -1, dtype=torch.int32, device=dev)
    rec(OperationMetrics.SAMPLER,
        lambda: sample_tokens(logits, temps, top_p, top_k, GREEDY))
    return results
