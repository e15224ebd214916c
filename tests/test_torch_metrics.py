"""The port's metrics modules on the CPU: the op profiler's rows, the host
phase rows, ``CpuTimer``, ``DeviceTimer`` and ``profile_session``.

The twin of tests/test_metrics.py's rows (its lines 44-53) on the port's
engine (device="cpu": plain kernel versions, host times).  Kernel A
rotates and appends in one launch, so its time is the KV-save row and no
rope row is recorded (metrics/op_profiler.py).
"""

import json
import os

import numpy as np
import torch

from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.metrics.metrics_store import CDFSketch, MetricsStore
from vattention_tpu_torch.metrics.timer import (CpuTimer, DeviceTimer,
                                                profile_session)


def test_serving_metrics_and_op_rows(tmp_path):
    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", attention_backend="fa_vattn",
        scheduler_type="sarathi", chunk_size=128, max_model_len=512,
        max_batch_size=4, max_num_seqs=4, write_metrics=True,
        output_dir=str(tmp_path), device="cpu")
    rng = np.random.default_rng(3)
    for i, n in enumerate([100, 60]):
        engine.add_request(
            prompt=None, prompt_token_ids=rng.integers(1, 2000, n).tolist(),
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=4, ignore_eos=True),
            seq_id=f"s{i}")
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
        assert steps < 500
    kv_before = engine.worker.cache_engine.kv_cache.clone()
    ops = engine.worker.profile_op_level(ctx=256, iters=1)
    store = engine.metrics_store
    summary = store.summary()

    for op in ("attn_prefill", "attn_decode", "attn_kv_cache_save",
               "attn_pre_proj", "mlp_up_proj", "sample"):
        assert op in ops and ops[op] > 0, op
        assert op in summary["operation_times"], op
    # kernel A's rotation is inside the KV-save row, never a row of its own
    assert "attn_rope" not in ops
    # the rows kernel A wrote are put back
    assert torch.equal(engine.worker.cache_engine.kv_cache, kv_before)

    cpu = summary["cpu_operation_times"]
    for op in ("schedule", "kv_cache_step", "prepare_inputs_e2e"):
        assert op in cpu and cpu[op]["count"] > 0, op
    assert cpu["kv_cache_step"]["count"] >= 5
    frag = summary["fragmentation_overhead"]
    assert frag["count"] > 0 and frag["max"] < 0.01, frag

    store.plot()
    assert os.path.exists(tmp_path / "operation_attn_decode.csv")
    engine.cleanup()
    MetricsStore._instance = None


def test_op_rows_on_the_paged_pool():
    """fa_paged: the prefill row runs kernel E's plain version over block
    tables, the decode row C's at the pool's block size."""
    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", attention_backend="fa_paged_16",
        max_model_len=512, max_batch_size=2, device="cpu")
    ops = engine.worker.profile_op_level(ctx=200, iters=1)
    assert all(ops[k] > 0 for k in ("attn_prefill", "attn_decode",
                                    "attn_kv_cache_save"))
    engine.cleanup()
    MetricsStore._instance = None


def test_cpu_timer_feeds_its_sketch():
    sketch = CDFSketch("phase")
    for _ in range(3):
        with CpuTimer(sketch, "phase") as t:
            sum(range(1000))
    assert len(sketch) == 3 and t.last > 0
    assert sketch.ys[-1] == t.last and min(sketch.ys) > 0


def test_profile_session_writes_a_trace_with_the_timer_ranges(tmp_path):
    x = torch.randn(64, 64)
    with profile_session(str(tmp_path), cuda=False) as prof:
        with DeviceTimer("port-matmul"):
            x @ x
    names = {e.key for e in prof.key_averages()}
    assert "port-matmul" in names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "port-matmul"
               for ev in trace["traceEvents"])


def test_worker_profiling_writes_a_chrome_trace(tmp_path):
    MetricsStore._instance = None
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32", max_model_len=256,
        max_batch_size=2, device="cpu")
    engine.worker.start_profiling(str(tmp_path))
    engine.add_request(prompt=None, prompt_token_ids=list(range(1, 30)),
                       sampling_params=SamplingParams(
                           temperature=0.0, max_tokens=2, ignore_eos=True),
                       seq_id="p")
    while engine.has_unfinished_requests():
        engine.step()
    path = engine.worker.stop_profiling()
    assert json.loads(open(path).read())["traceEvents"]
    engine.cleanup()
    MetricsStore._instance = None
