"""The port's benchmark package against the JAX package's, on the CPU.

``vattention_tpu_torch.benchmark`` is the twin of
``vattention_tpu.benchmark``: the request generators draw the same
``Request`` lists float for float, the YAML config flattens the same (the
port adds only the engine's ``device``), the runners give the same totals
and greedy tokens (float32, the JAX engine's weights carried over with
``params_from_jax``; times are not compared), the multi-replica launcher
passes tests/test_multi_replica.py's checks, and the capacity search
probes the JAX sequence except where the JAX package under-reports (the
SLO binding at 64 qps: the port bisects, ADVICE.md's fix).  The port's
runner warms every step signature its timed run meets, and its async
engine stamps a request's first token and completion when the token
reaches the host.
Both packages' ``MetricsStore`` singletons are reset around every test.
``main --test --device cpu`` is in tests/test_torch_benchmark_main.py.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from vattention_tpu.benchmark import benchmark_runner as jax_runner
from vattention_tpu.benchmark.capacity_search import (
    CapacitySearch as JaxCapacitySearch)
from vattention_tpu.benchmark.config import ConfigParser as JaxConfigParser
from vattention_tpu.benchmark.config import (
    flat_to_runner_args as jax_flat_to_runner_args)
from vattention_tpu.benchmark.request_generator import (
    RequestGeneratorRegistry as JaxRegistry)
from vattention_tpu_torch.benchmark import benchmark_runner as port_runner
from vattention_tpu_torch.benchmark.capacity_search import CapacitySearch
from vattention_tpu_torch.benchmark.config import (ConfigParser,
                                                   flat_to_runner_args)
from vattention_tpu_torch.benchmark.request_generator import (
    RequestGeneratorRegistry)
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = os.path.join(ROOT, "data", "processed_traces",
                     "arxiv_synthetic_v2.csv")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU steps are many small ops: one thread runs them as
    fast as eight, and does not stall when other test processes share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_metrics():
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore as T

    J._instance = None
    T._instance = None
    yield
    J._instance = None
    T._instance = None


def lag(monkeypatch):
    """Both packages' step handles report their samples pending until the
    in-flight queue is full, as on a card, so the step counts of the two
    async engines do not depend on when the CPU finishes a step."""
    from vattention_tpu.model_executor.model_runner import (
        StepHandle as JaxStepHandle)
    from vattention_tpu_torch.model_executor.model_runner import StepHandle

    monkeypatch.setattr(StepHandle, "is_ready", lambda self: False)
    monkeypatch.setattr(JaxStepHandle, "is_ready", lambda self: False)


def as_tuples(requests):
    return [(r.arrival_time, r.num_prefill_tokens, r.num_decode_tokens)
            for r in requests]


# ------------------------------------------------------------------ #
# request generators
# ------------------------------------------------------------------ #
_LENGTHS = {
    "fixed": dict(prefill_tokens=1000, decode_tokens=37),
    "uniform": dict(min_tokens=128, max_tokens=4096,
                    prefill_to_decode_ratio=8.0),
    "zipf": dict(min_tokens=1024, max_tokens=4096, theta=0.6,
                 scramble=False, prefill_to_decode_ratio=20.0),
    # max_tokens below the trace's longest prompts, so both clamps act
    "trace": dict(trace_file=TRACE, prefill_scale_factor=0.7,
                  decode_scale_factor=1.3, max_tokens=8192),
}


@pytest.mark.parametrize("interval,length", [
    *[(i, n) for i in ("static", "poisson", "gamma") for n in _LENGTHS],
    ("trace_replay", None),
])
def test_generators_draw_the_jax_requests(interval, length):
    if interval == "trace_replay":
        provider = "trace_replay"
        config = dict(trace_file=TRACE, time_scale_factor=0.5,
                      max_tokens=16384, num_requests=200)
    else:
        provider = "synthetic"
        config = dict(num_requests=300, interval_generator=interval,
                      length_generator=length, qps=3.0, cv=0.7, seed=11,
                      **_LENGTHS[length])
    got = RequestGeneratorRegistry.get(provider, dict(config)).generate()
    expect = JaxRegistry.get(provider, dict(config)).generate()
    assert as_tuples(got) == as_tuples(expect)
    assert len(got) == config["num_requests"]
    if length == "trace" or interval == "trace_replay":
        assert max(r.num_prefill_tokens + r.num_decode_tokens
                   for r in got) <= config["max_tokens"]


# ------------------------------------------------------------------ #
# the YAML config
# ------------------------------------------------------------------ #
_OVERRIDES = [
    [],
    ["--seed", "3", "--model_name", "yi-6b-200k-l16",
     "--write_metrics", "false", "--sarathi_scheduler_chunk_size", "2048"],
    ["--synthetic_request_generator_length_provider", "trace",
     "--synthetic_request_generator_interval_provider", "poisson",
     "--trace_request_length_generator_trace_file", TRACE],
    ["--synthetic_request_generator_length_provider", "uniform",
     "--synthetic_request_generator_interval_provider", "gamma",
     "--replica_scheduler_provider", "vllm", "--model_block_size", "256"],
    ["--synthetic_request_generator_length_provider", "zipf",
     "--request_generator_provider", "trace",
     "--trace_request_generator_trace_file", TRACE,
     "--replica_scheduler_provider", "simple_chunking"],
]


@pytest.mark.parametrize("argv", _OVERRIDES)
def test_config_flattens_as_the_jax_config(argv):
    port, ref = ConfigParser(), JaxConfigParser()
    assert port.defaults == ref.defaults
    flat = port.parse_args(argv)
    assert flat.pop("device") == "cuda"
    assert flat == ref.parse_args(argv)
    got = flat_to_runner_args(dict(flat, device="cpu"))
    expect = jax_flat_to_runner_args(ref.parse_args(argv))
    assert got[0].pop("device") == "cpu"
    assert got == expect


def test_config_device_from_the_flag_or_a_yaml_file(tmp_path):
    path = tmp_path / "cpu.yml"
    path.write_text("device: cpu\nseed: 7\nmodel:\n  name: tiny-llama-debug\n")
    flat = ConfigParser().parse_args(["--config_file", str(path)])
    kwargs = flat_to_runner_args(flat)[0]
    assert (kwargs["device"], kwargs["seed"], kwargs["model"]) == (
        "cpu", 7, "tiny-llama-debug")
    flat = ConfigParser().parse_args(["--config_file", str(path),
                                      "--device", "cuda"])
    assert flat_to_runner_args(flat)[0]["device"] == "cuda"


# ------------------------------------------------------------------ #
# the runner
# ------------------------------------------------------------------ #
def collect_tokens(engine):
    """Wrap ``engine.step`` so the finished requests' tokens are kept."""
    out = {}
    step = engine.step

    def wrapped():
        outputs = step()
        for o in outputs:
            if o.finished:
                out[o.seq_id] = list(o.token_ids)
        return outputs
    engine.step = wrapped
    return out


def _runner_kwargs(backend, tmp_path):
    return dict(model="tiny-llama-debug", dtype="float32",
                attention_backend=backend, scheduler_type="sarathi",
                chunk_size=128, max_model_len=512, max_batch_size=4,
                max_num_seqs=4, gpu_memory_utilization=0.9,
                write_metrics=True, output_dir=str(tmp_path))


_STATIC = dict(num_requests=5, interval_generator="static",
               length_generator="uniform", min_tokens=100, max_tokens=400,
               prefill_to_decode_ratio=20.0, seed=2)


@pytest.mark.parametrize("backend", ["fa_vattn", "fa_vattn_64kb"])
def test_runner_matches_the_jax_runner(backend, tmp_path, monkeypatch):
    lag(monkeypatch)
    kw = _runner_kwargs(backend, tmp_path)
    ref = jax_runner.BenchmarkRunner(kw, "synthetic", dict(_STATIC))
    np_params = jax.tree.map(np.asarray,
                             ref.engine.worker.model_runner.params)
    expect_tokens = collect_tokens(ref.engine)
    expect = ref.run()
    ref.engine.cleanup()

    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    runner = port_runner.BenchmarkRunner(
        dict(kw, load_format="zero", device="cpu"), "synthetic",
        dict(_STATIC))
    runner.engine.worker.model_runner.params = params_from_jax(np_params)
    tokens = collect_tokens(runner.engine)
    got = runner.run()
    runner.engine.cleanup()

    keys = ("completed_requests", "processed_tokens", "decode_tokens",
            "num_steps", "preemptions")
    assert {k: got["totals"][k] for k in keys} == {
        k: expect["totals"][k] for k in keys}
    assert got["totals"]["completed_requests"] == _STATIC["num_requests"]
    counts = [k for k in expect["phase_stats"] if not k.endswith("_time_s")]
    assert {k: got["phase_stats"][k] for k in counts} == {
        k: expect["phase_stats"][k] for k in counts}
    bench = {s: t for s, t in tokens.items() if s.startswith("bench")}
    assert len(bench) == _STATIC["num_requests"]
    assert bench == {s: t for s, t in expect_tokens.items()
                     if s.startswith("bench")}
    assert set(got) == set(expect)


def test_warmup_meets_every_signature_of_the_timed_run(tmp_path):
    """On fa_pod the timed run's prompts, mixed (fused) and decode steps
    all have their signature met in the warm-up, on the staged buffer the
    timed run uses (so on a card no graph is captured while timing)."""
    runner = port_runner.BenchmarkRunner(
        dict(_runner_kwargs("fa_pod", tmp_path), device="cpu"), "synthetic",
        dict(_STATIC))
    model_runner = runner.engine.worker.model_runner
    met = {}
    launch = model_runner._launch

    def spy(inputs, n_pre, mode):
        sig = model_runner.signature(inputs, n_pre, mode)
        met.setdefault(phase[0], {}).setdefault(sig, set()).add(
            inputs.token_ids.data_ptr())
        return launch(inputs, n_pre, mode)
    model_runner._launch = spy
    warmup = runner._warmup
    phase = ["warmup"]

    def spied_warmup():
        warmup()
        phase[0] = "timed"
    runner._warmup = spied_warmup
    summary = runner.run()
    runner.engine.cleanup()
    assert summary["totals"]["completed_requests"] == _STATIC["num_requests"]
    timed, warm = met["timed"], met["warmup"]
    assert any(sig[1] for sig in timed), "no fused step in the timed run"
    assert set(timed) <= set(warm)
    for sig, buffers in timed.items():
        assert buffers == warm[sig], sig


def test_two_replicas_complete_all_requests(tmp_path):
    """tests/test_multi_replica.py's checks on the port's launcher."""
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    engine_kwargs = dict(
        model="tiny-llama-debug", dtype="float32", load_format="zero",
        attention_backend="fa_vattn", scheduler_type="sarathi",
        chunk_size=128, max_model_len=1024, max_batch_size=4,
        max_num_seqs=4, gpu_memory_utilization=0.8,
        write_metrics=True, output_dir=str(tmp_path), device="cpu")
    generator_config = dict(
        num_requests=4, prefill_tokens=100, decode_tokens=4,
        interval_generator="static", length_generator="fixed", seed=0)
    launcher = port_runner.BenchmarkRunnerLauncher(
        engine_kwargs, "synthetic", generator_config,
        num_replicas=2, warmup=False)
    assert launcher.replica_stores[0] is not launcher.replica_stores[1]
    assert (launcher.runners[0].engine.metrics_store
            is launcher.replica_stores[0])
    assert (launcher.runners[1].engine.metrics_store
            is launcher.replica_stores[1])
    assert len(launcher.runners[0].requests) == 2
    assert len(launcher.runners[1].requests) == 2

    summary = launcher.run()
    for r in launcher.runners:
        r.engine.cleanup()
    MetricsStore._instance = None

    assert summary["totals"]["num_replicas"] == 2
    assert summary["totals"]["completed_requests"] == 4
    per = summary["per_replica_totals"]
    assert [p["completed_requests"] for p in per] == [2, 2]
    assert summary["totals"]["decode_tokens"] == sum(
        p["decode_tokens"] for p in per)
    assert summary["request_e2e_time"]["count"] == 4
    written = json.load(open(os.path.join(tmp_path, "summary.json")))
    assert written["request_e2e_time"]["count"] == 4


# ------------------------------------------------------------------ #
# the capacity search
# ------------------------------------------------------------------ #
def _search(cls, threshold, monkeypatch):
    """The search with each probe passing iff qps <= threshold."""
    def probe(self, qps):
        self.probes.append(qps)
        return qps <= threshold
    monkeypatch.setattr(cls, "_probe", probe)
    search = cls({}, {}, None)
    return search.search(), search.probes


@pytest.mark.parametrize("threshold", [0.1, 5.0, 20.0, 100.0])
def test_capacity_search_probes_the_jax_sequence(threshold, monkeypatch):
    assert (_search(CapacitySearch, threshold, monkeypatch)
            == _search(JaxCapacitySearch, threshold, monkeypatch))


def test_capacity_search_bisects_when_the_slo_binds_at_64(monkeypatch):
    """The pinned divergence: a threshold between 32 and 64 fails the
    probe at 64; the JAX package returns 32 there, the port bisects."""
    expect, ref_probes = _search(JaxCapacitySearch, 40.0, monkeypatch)
    assert (expect, ref_probes) == (32.0, [0.25, 16.0, 32.0, 64.0])
    got, probes = _search(CapacitySearch, 40.0, monkeypatch)
    assert probes[:4] == ref_probes and len(probes) > 4
    assert all(32.0 < q < 64.0 for q in probes[4:])
    assert 40.0 - 0.25 <= got <= 40.0


# ------------------------------------------------------------------ #
# the async engine's stamps
# ------------------------------------------------------------------ #
def test_async_stamps_first_token_and_completion_when_read(monkeypatch):
    """With the samples read two steps after dispatch (a card's lag), a
    request's first token and completion are stamped when their step's
    samples are read, not when the step was dispatched, so makespan and
    TTFT cover the device time of the last steps: each stamp lies after
    the read and before the end of the engine step that read it."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.model_executor.model_runner import ModelRunner

    lag(monkeypatch)
    read_at = {}   # seq_id -> times its samples were read
    resolve = ModelRunner.resolve

    def timed_resolve(handle):
        out = resolve(handle)
        now = time.monotonic()
        for seq, _, _ in handle.sampled:
            read_at.setdefault(seq.seq_id, []).append(now)
        return out
    monkeypatch.setattr(ModelRunner, "resolve", staticmethod(timed_resolve))
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32",
        attention_backend="fa_vattn", scheduler_type="sarathi",
        max_model_len=512, max_batch_size=4, max_num_seqs=4,
        chunk_size=128, device="cpu")
    seqs, step_ends = {}, []
    rng = np.random.default_rng(1)
    for i, n in enumerate((150, 45, 300)):
        engine.add_request(prompt=None, seq_id=f"r{i}",
                           prompt_token_ids=rng.integers(1, 2000, n).tolist(),
                           sampling_params=SamplingParams(
                               temperature=0.0, max_tokens=5,
                               ignore_eos=True))
        seqs[f"r{i}"] = engine.seq_manager.seq_map[f"r{i}"]
    while engine.has_unfinished_requests():
        engine.step()
        step_ends.append(time.monotonic())
    engine.cleanup()

    def end_of_step(t):
        return min(e for e in step_ends if e >= t)

    for seq_id, seq in seqs.items():
        state = seq.state
        first, last = read_at[seq_id][0], read_at[seq_id][-1]
        assert len(read_at[seq_id]) == 5
        assert first <= state.prompt_processing_completed_at <= \
            end_of_step(first)
        assert last <= state.completed_at <= end_of_step(last)


def test_memory_pressure_does_not_run_the_arena_out(monkeypatch):
    """16 requests of the trace's lengths (prompts halved, decodes 4x) at
    once into a 32,768-token arena of 128-token blocks.  Without the
    admitted prompts' unmapped blocks kept promised (the JAX package's
    accounting) the scheduler admits past the arena and the allocator
    runs out of blocks at step 565; the port serves past it, relocating
    extents.  The Python allocator raises where the native core aborts.
    The schedule does not depend on the tokens (``ignore_eos``), so the
    model's step is replaced by one that samples token 0."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.microbenchmarks.benchmark_phase import (
        utilization_for_kv)
    from vattention_tpu_torch.model_executor.model_runner import ModelRunner

    monkeypatch.setattr(
        ModelRunner, "_step", lambda self, inputs, n_pre, mode=None:
        torch.zeros((self.B, 2), dtype=torch.int32))
    kw = dict(model="tiny-llama-debug", dtype="bfloat16", seed=0,
              attention_backend="fa_vattn_64kb", scheduler_type="sarathi",
              chunk_size=512, max_batch_size=16, max_num_seqs=16,
              max_model_len=32768, device="cpu", use_native_allocator=False)
    kw["gpu_memory_utilization"] = utilization_for_kv(kw, 64 * 2**20)
    engine = LLMEngine.from_engine_args(**kw)
    ce = engine.worker.cache_engine
    assert ce.allocator.num_arena_blocks * ce.block_tokens == 32768
    requests = RequestGeneratorRegistry.get("synthetic", dict(
        num_requests=16, interval_generator="static",
        length_generator="trace", trace_file=TRACE,
        prefill_scale_factor=0.5, decode_scale_factor=4.0,
        max_tokens=32768, seed=0)).generate()
    rng = np.random.default_rng(0)
    for i, r in enumerate(requests):
        engine.add_request(
            prompt=None, seq_id=f"b{i}",
            prompt_token_ids=rng.integers(1, 1000,
                                          r.num_prefill_tokens).tolist(),
            sampling_params=SamplingParams(
                temperature=0.0, max_tokens=r.num_decode_tokens,
                ignore_eos=True))
    steps = 0
    while engine.has_unfinished_requests():
        engine.step()
        steps += 1
    assert steps > 565
    assert engine.metrics_store.num_completed_requests == 16
    assert ce.pending_moves > 0
    engine.cleanup()


@pytest.mark.parametrize("fault", [False, True])
def test_serve_holds_each_relocation_plan_against_the_plain_version(
        fault, tmp_path, monkeypatch):
    """chip_smoke's (r dyn) check at the tiny model's size: 16 requests
    of the trace's lengths (prompts x 0.12, decodes x 4), all at once (arrivals over time would make
    the schedule depend on the host's speed), into an 8 MiB
    fa_vattn_64kb arena filled with seeded noise plan block moves, and
    ``serve(check_relocations=True)`` holds each plan against
    ``arena_relocate_plain`` on a clone of the arena.  A relocation that
    drops its last move is caught.  The schedule does not depend on the
    tokens, so the model's step samples token 0."""
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase
    from vattention_tpu_torch.model_executor.model_runner import ModelRunner
    from vattention_tpu_torch.worker.cache_engine import vattn_cache_engine

    monkeypatch.setattr(
        ModelRunner, "_step", lambda self, inputs, n_pre, mode=None:
        torch.zeros((self.B, 2), dtype=torch.int32))
    init = vattn_cache_engine.VAttnCacheEngine.__init__

    def noisy_init(self, *a, **kw):
        init(self, *a, **kw)
        g = torch.Generator().manual_seed(0)
        self.kv_cache.copy_(torch.randn(self.kv_cache.shape, generator=g))
    monkeypatch.setattr(vattn_cache_engine.VAttnCacheEngine, "__init__",
                        noisy_init)
    if fault:
        relocate = vattn_cache_engine.arena_relocate
        monkeypatch.setattr(
            vattn_cache_engine, "arena_relocate",
            lambda kv, src, dst, n, bt: relocate(kv, src, dst, n - 1, bt))
    kw = dict(model="tiny-llama-debug", dtype="float32", seed=0,
              attention_backend="fa_vattn_64kb", scheduler_type="sarathi",
              chunk_size=128, max_batch_size=8, max_num_seqs=8,
              max_model_len=4096, device="cpu", use_native_allocator=False,
              write_metrics=True, output_dir=str(tmp_path))
    kw["gpu_memory_utilization"] = phase.utilization_for_kv(kw, 8 * 2**20)
    gen = dict(num_requests=16, interval_generator="static",
               length_generator="trace", trace_file=TRACE,
               prefill_scale_factor=0.12, decode_scale_factor=4.0,
               max_tokens=4096, seed=0)
    if fault:
        with pytest.raises(AssertionError, match="differs from "
                           "arena_relocate_plain"):
            phase.serve(kw, gen, check_relocations=True)
        return
    res = phase.serve(kw, gen, check_relocations=True)
    res["runner"].engine.cleanup()
    assert res["summary"]["totals"]["completed_requests"] == 16
    assert res["plans"] >= 1 and res["moves"] > 0
    assert [ok for _, ok in res["relocations"]] == [True] * res["plans"]
    assert sum(m for m, _ in res["relocations"]) == res["moves"]
