"""The port's metrics modules on the CPU: the op profiler's rows, the host
phase rows, the host spans (``metrics/timer.span``) and
``profile_session``.

The twin of tests/test_metrics.py's rows (its lines 44-53) on the port's
engine (device="cpu": plain kernel versions, host times).  Kernel A
rotates and appends in one launch, so its time is the KV-save row and no
rope row is recorded (metrics/op_profiler.py).
"""

import gc
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.core.datatypes.sequence_state import SequenceState
from vattention_tpu_torch.metrics import timer
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.metrics.timer import profile_session, span
from vattention_tpu_torch.model_executor.model_runner import (ModelRunner,
                                                              StepGraph,
                                                              StepHandle)


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
    # no profiler and no chrome trace: the spans fed the sketches only
    assert cpu["schedule"]["count"] == steps
    assert not store.spans
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


@pytest.fixture
def store():
    MetricsStore._instance = None
    yield MetricsStore.get_instance()
    MetricsStore._instance = None


def test_cpu_timer_feeds_its_sketch(store):
    """The span that replaced ``CpuTimer``: not recording, it pushes its
    duration into its sketch and records nothing."""
    for _ in range(3):
        with span(store, timer.SCHEDULE) as s:
            sum(range(1000))
    with span(store, timer.LAUNCH):
        pass
    assert not s.recording and not store.spans
    sketch = store.cpu_operation_times["schedule"]
    assert len(sketch) == 3 and min(sketch.ys) > 0
    # a span without a sketch feeds none
    assert set(store.cpu_operation_times) == {"schedule"}


def test_profile_session_writes_a_trace_with_the_timer_ranges(tmp_path,
                                                              store):
    """The span that replaced ``DeviceTimer``'s range: its name is a
    range of the profiler's trace around the ops inside it."""
    x = torch.randn(64, 64)
    with profile_session(str(tmp_path), cuda=False) as prof:
        with span(store, timer.LAUNCH):
            x @ x
    names = {e.key for e in prof.key_averages()}
    assert timer.LAUNCH in names
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == timer.LAUNCH
               for ev in events["traceEvents"])


def test_spans_nest_under_the_profiler(store):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span(store, timer.STEP, extra=7) as step:
                with span(store, timer.SCHEDULE):
                    pass
                with span(store, timer.OUTPUTS) as out:
                    with span(store, timer.RESOLVE_WAIT, flush=1):
                        pass
                    out.counts["outputs"] = 3
        with span(store, timer.KV_STEP):
            pass
    assert step.recording
    recs = list(store.spans)
    assert [r.name for r in recs] == 2 * [
        timer.SCHEDULE, timer.RESOLVE_WAIT, timer.OUTPUTS, timer.STEP] + [
        timer.KV_STEP]
    parents = {timer.SCHEDULE: timer.STEP, timer.OUTPUTS: timer.STEP,
               timer.RESOLVE_WAIT: timer.OUTPUTS, timer.STEP: None,
               timer.KV_STEP: None}
    for r in recs:
        assert r.parent == parents[r.name], r
        assert r.start_ns <= r.end_ns
    steps = [r for r in recs if r.name == timer.STEP]
    assert [r.step for r in steps] == [1, 2]
    assert [r.counts for r in steps] == [{"extra": 7, "step": 1},
                                         {"extra": 7, "step": 2}]
    for r in recs[:4]:
        assert r.step == 1
        assert steps[0].start_ns <= r.start_ns <= r.end_ns \
            <= steps[0].end_ns
    assert recs[2].counts == {"outputs": 3}
    assert recs[1].counts == {"flush": 1}
    assert recs[-1].step is None
    assert not store.open_spans
    # the sketches are fed as when not recording
    assert len(store.cpu_operation_times["schedule"]) == 2
    names = {e.key for e in prof.key_averages()}
    assert {r.name for r in recs} <= names


def test_recorded_spans_leave_nothing_for_the_collector(store):
    """Recording allocates no object the garbage collector tracks, so the
    kept spans never make a full collection stall the engine."""
    with profile(activities=[ProfilerActivity.CPU]):
        with span(store, timer.STEP):
            pass
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(2000):
            with span(store, timer.STEP, extra=1) as s:
                with span(store, timer.PREPARE):
                    pass
                s.counts["more"] = 2
        gc.collect()
        after = len(gc.get_objects())
    assert len(store.spans) == 4001
    assert after - before < 100


def test_span_names_are_unique_and_prefixed():
    assert len(set(timer.NAMES)) == len(timer.NAMES) == 8
    for name in timer.NAMES:
        assert name.startswith("vattn."), name


def _engine(**kw):
    MetricsStore._instance = None
    return LLMEngine.from_engine_args(
        model="tiny-llama-debug", attention_backend="fa_vattn",
        scheduler_type="sarathi", chunk_size=128, max_model_len=512,
        max_batch_size=4, max_num_seqs=4, device="cpu", **kw)


def _serve(engine, prompts, max_tokens=4):
    """Each step's outputs, in order (the engine's steps under way)."""
    rng = np.random.default_rng(5)
    for i, n in enumerate(prompts):
        engine.add_request(
            prompt=None, prompt_token_ids=rng.integers(1, 2000, n).tolist(),
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=max_tokens, ignore_eos=True),
            seq_id=f"s{i}")
    per_step = []
    while engine.has_unfinished_requests():
        per_step.append(engine.step())
        assert len(per_step) < 500
    return per_step


def test_engine_steps_carry_their_spans(monkeypatch):
    """Each engine step is one ``vattn.step`` holding its phases; the
    outputs span counts the tokens copied into the outputs the step
    returned; a request's prefill span ends at its state's stamp of the
    dispatch of its last chunk."""
    # the lag of a card: a step's samples land only when waited for
    monkeypatch.setattr(StepHandle, "is_ready", lambda self: False)
    stamps = {}
    stamp = SequenceState.on_prompt_processing_completed

    def first_stamp(state):
        stamp(state)
        stamps.setdefault(state._id, state.prompt_processing_completed_at)

    monkeypatch.setattr(SequenceState, "on_prompt_processing_completed",
                        first_stamp)
    engine = _engine()
    with profile(activities=[ProfilerActivity.CPU]):
        per_step = _serve(engine, [300, 60, 200])
    recs = list(engine.metrics_store.spans)
    steps = [r for r in recs if r.name == timer.STEP]
    assert [r.step for r in steps] == list(range(1, len(per_step) + 1))
    by_step = {r.step: r for r in steps}
    inner = [r for r in recs if r.name not in (timer.STEP,
                                               timer.REQUEST_PREFILL)]
    for r in inner:
        outer = by_step[r.step]
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
        assert r.parent == timer.STEP
    names = {r.name for r in inner}
    assert names == {timer.SCHEDULE, timer.KV_STEP, timer.PREPARE,
                     timer.LAUNCH, timer.RESOLVE_WAIT, timer.OUTPUTS}
    # the last steps drain the pipeline through flush_inflight
    waits = [r for r in recs if r.name == timer.RESOLVE_WAIT]
    assert {r.counts["flush"] for r in waits} == {0, 1}
    for step_id, outputs in enumerate(per_step, start=1):
        copied = sum(r.counts["tokens_copied"] for r in inner
                     if r.name == timer.OUTPUTS and r.step == step_id)
        assert copied == sum(len(o.token_ids) for o in outputs)
        assert by_step[step_id].counts == {"step": step_id}
    # one prefill span per request, kept on the step that dispatched its
    # last chunk
    prefills = [r for r in recs if r.name == timer.REQUEST_PREFILL]
    assert sorted(r.counts["seq_id"] for r in prefills) == ["s0", "s1", "s2"]
    for r in prefills:
        assert r.end_ns == round(stamps[r.counts["seq_id"]] * 1e9)
        assert r.start_ns < r.end_ns
        assert by_step[r.step].start_ns <= r.end_ns <= by_step[r.step].end_ns
    engine.cleanup()
    MetricsStore._instance = None


def test_captured_is_counted_on_a_signatures_first_step(monkeypatch):
    """``captured`` is 1 on the step that captured its signature's graph,
    0 on the replays.  The CPU cannot capture: the capture is stood in for
    by a graph whose replay runs the eager step on the captured inputs,
    so the served tokens stay the engine's own."""
    def fake_capture(self, inputs, n_pre, mode):
        out = torch.zeros(self.B, 2 + 2 * self.logprobs_top,
                          dtype=torch.int32)

        class Graph:
            @staticmethod
            def replay():
                out.copy_(self._step(inputs, n_pre, mode))

        return StepGraph(Graph(), out, {}, 0.0, None,
                         inputs.token_ids.data_ptr())

    sigs = []
    launch = ModelRunner._launch

    def tracked(self, inputs, n_pre, mode):
        sigs.append(ModelRunner.signature(inputs, n_pre, mode))
        return launch(self, inputs, n_pre, mode)

    expected = _serve(_engine(), [300, 60], max_tokens=6)
    monkeypatch.setattr(ModelRunner, "_capture", fake_capture)
    monkeypatch.setattr(ModelRunner, "_launch", tracked)
    engine = _engine()
    engine.worker.model_runner.captures = True
    with profile(activities=[ProfilerActivity.CPU]):
        got = _serve(engine, [300, 60], max_tokens=6)
    assert [[(o.seq_id, o.token_ids) for o in step] for step in got] == [
        [(o.seq_id, o.token_ids) for o in step] for step in expected]
    recs = list(engine.metrics_store.spans)
    captured = [r.counts["captured"] for r in recs if r.name == timer.LAUNCH]
    assert captured == [int(sig not in sigs[:i]) for i, sig in enumerate(sigs)]
    assert sum(captured) == len(set(sigs)) == 2
    assert len(engine.worker.model_runner.graphs) == 2
    engine.cleanup()
    MetricsStore._instance = None


def test_chrome_trace_holds_the_spans(tmp_path):
    """``enable_chrome_trace`` records without a profiler and writes the
    spans: the nested ones as complete events, each request's prefill as
    an async span keyed by its ``seq_id``."""
    engine = _engine(write_metrics=True, output_dir=str(tmp_path),
                     enable_chrome_trace=True)
    per_step = _serve(engine, [300, 60])
    engine.metrics_store.plot()
    events = json.loads(
        (tmp_path / "chrome_trace.json").read_text())["traceEvents"]
    steps = [e for e in events if e["name"] == timer.STEP]
    assert len(steps) == len(per_step)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in steps)
    assert [e["args"]["step"] for e in steps] == list(
        range(1, len(per_step) + 1))
    prefill = [e for e in events if e["name"] == timer.REQUEST_PREFILL]
    assert sorted((e["id"], e["ph"]) for e in prefill) == [
        ("s0", "b"), ("s0", "e"), ("s1", "b"), ("s1", "e")]
    engine.cleanup()
    MetricsStore._instance = None


def test_each_replica_keeps_its_own_spans(tmp_path):
    """Two replicas in one process: each engine, worker and runner records
    into its replica's store, so each store holds its own steps alone."""
    from vattention_tpu_torch.benchmark.benchmark_runner import (
        BenchmarkRunnerLauncher)

    MetricsStore._instance = None
    launcher = BenchmarkRunnerLauncher(
        dict(model="tiny-llama-debug", dtype="float32", load_format="zero",
             attention_backend="fa_vattn", scheduler_type="sarathi",
             chunk_size=128, max_model_len=1024, max_batch_size=4,
             max_num_seqs=4, gpu_memory_utilization=0.8,
             write_metrics=True, enable_chrome_trace=True,
             output_dir=str(tmp_path), device="cpu"),
        "synthetic",
        dict(num_requests=4, prefill_tokens=100, decode_tokens=4,
             interval_generator="static", length_generator="fixed", seed=0),
        num_replicas=2, warmup=False)
    steps = []
    for r in launcher.runners:
        engine, count = r.engine, [0]
        step = engine.step

        def counted(step=step, count=count):
            count[0] += 1
            return step()

        engine.step = counted
        steps.append(count)
    launcher.run()
    for r, count, store in zip(launcher.runners, steps,
                               launcher.replica_stores):
        assert r.engine.worker.model_runner._metrics_store is store
        recs = store.spans
        assert len(store.cpu_operation_times["schedule"]) == count[0] > 0
        assert sum(rec.name == timer.STEP for rec in recs) == count[0]
        assert len(store.cpu_operation_times["prepare_inputs_e2e"]) == sum(
            rec.name == timer.PREPARE for rec in recs) > 0
        # each replica served two of the four requests
        prefills = [rec for rec in recs if rec.name == timer.REQUEST_PREFILL]
        assert len(prefills) == len({rec.counts["seq_id"]
                                     for rec in prefills}) == 2
        assert all(rec.step is not None for rec in prefills)
        r.engine.cleanup()
    MetricsStore._instance = None


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
