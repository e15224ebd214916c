"""Async execution of the PyTorch port, on the CPU, against the JAX package.

The twins of tests/test_async_execution.py on the port's engine
(device="cpu"): lagged host reads must not change results.  The port's
async engine (the default) gives the same greedy tokens as its sync
engine and as the JAX async engine with the same weights
(``params_from_jax``) on the workloads of
tests/test_e2e.py::test_engine_matches_dense_reference.  The sampler
takes its mode from the host: it must equal the sampler as it was when it
read the mode from the device (kept here as ``sample_tokens_device_mode``)
under one generator seed, and the JAX sampler on greedy rows.  The splice
of the previous step's tokens equals the JAX runner's.  float32
throughout; greedy tokens compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vattention_tpu import LLMEngine as JaxLLMEngine
from vattention_tpu import SamplingParams as JaxSamplingParams
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.core.datatypes.sampling_params import (
    SamplingParams as SP)
from vattention_tpu_torch.core.datatypes.sequence import Sequence
from vattention_tpu_torch.core.datatypes.sequence_status import SequenceStatus
from vattention_tpu_torch.model_executor.layers import sampler as ts
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax


def fresh_metrics():
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore as T

    J._instance = None
    T._instance = None


def drain(engine, sampling_cls, prompts, max_tokens, check=None):
    for seq_id, ids in prompts.items():
        engine.add_request(
            prompt=None, prompt_token_ids=ids, seq_id=seq_id,
            sampling_params=sampling_cls(temperature=0.0,
                                         max_tokens=max_tokens,
                                         ignore_eos=True))
    out = {}
    steps = 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if check is not None:
                check(o)
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        assert steps < 500
    return out


def _run_engine(async_mode, max_inflight=2, num_requests=2, max_tokens=5):
    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32",
        attention_backend="fa_vattn", scheduler_type="sarathi",
        max_model_len=512, max_batch_size=4, max_num_seqs=4,
        chunk_size=128, gpu_memory_utilization=0.9,
        enable_async_execution=async_mode,
        max_inflight_steps=max_inflight, device="cpu")
    rng = np.random.default_rng(7)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([150, 45, 100])}
    out = drain(engine, SamplingParams,
                dict(list(prompts.items())[:num_requests]), max_tokens)
    engine.cleanup()
    fresh_metrics()
    return out


def test_async_matches_sync():
    sync = _run_engine(async_mode=False)
    for depth in (1, 3):
        async_out = _run_engine(async_mode=True, max_inflight=depth)
        assert async_out == sync, (depth, async_out, sync)


def test_outputs_expose_only_resolved_tokens():
    """Mid-run RequestOutputs never contain pending placeholders."""
    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32",
        attention_backend="fa_vattn", scheduler_type="sarathi",
        max_model_len=512, max_batch_size=2, max_num_seqs=2,
        chunk_size=128, enable_async_execution=True, device="cpu")
    toks = np.random.default_rng(3).integers(1, 2000, 100).tolist()

    def check(out):
        assert all(t >= 0 for t in out.token_ids), out.token_ids
    drain(engine, SamplingParams, {"s": toks}, 6, check)
    engine.cleanup()
    fresh_metrics()


def lag_on_the_cpu(monkeypatch):
    """On the CPU a step's samples are ready when it returns; report them
    pending until the in-flight queue is full, as a card would while it
    runs the step, so the next step's decodes read their tokens from the
    device token buffer."""
    from vattention_tpu_torch.model_executor.model_runner import StepHandle

    monkeypatch.setattr(StepHandle, "is_ready", lambda self: False)


def test_async_is_the_default_and_runs(monkeypatch):
    """enable_async_execution is on by default, as in the JAX package; an
    engine built with the defaults serves through the async branch, keeps
    max_inflight_steps steps in flight, splices pending tokens in on the
    device, and gives the sync engine's tokens."""
    from vattention_tpu_torch.config import SystemConfig
    from vattention_tpu_torch.engine.arg_utils import EngineArgs

    assert EngineArgs().enable_async_execution is True
    assert SystemConfig().enable_async_execution is True
    lag_on_the_cpu(monkeypatch)
    prompts = {"r": list(range(1, 40)), "s": list(range(7, 90))}
    got = {}
    for async_mode in (True, False):
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            model="tiny-llama-debug", dtype="float32", max_model_len=256,
            max_batch_size=2, device="cpu",
            **({} if async_mode else dict(enable_async_execution=False)))
        assert engine.async_execution == async_mode
        inflight, spliced = [], []
        runner = engine.worker.model_runner
        dispatch, stage = (engine.worker.execute_model_async,
                           runner._stager.stage)

        def spy_dispatch(*args, **kwargs):
            resolved = dispatch(*args, **kwargs)
            inflight.append(len(engine.worker._inflight))
            return resolved

        def spy_stage(**arrays):
            spliced.append(int(arrays["use_prev_tok"].sum()))
            return stage(**arrays)
        engine.worker.execute_model_async = spy_dispatch
        runner._stager.stage = spy_stage
        got[async_mode] = drain(engine, SamplingParams, prompts, 5)
        assert not engine.worker.has_inflight_steps()
        if async_mode:
            assert max(inflight) == engine.max_inflight_steps == 2
            assert max(spliced) == 2
        else:
            assert not inflight and max(spliced) == 0
        engine.cleanup()
    fresh_metrics()
    assert got[True] == got[False]
    assert all(len(v) == 5 for v in got[True].values())


def test_idle_slots_are_greedy():
    """A slot that samples nothing has temperature 0 in the step's arrays
    (JAX: 1.0), so a greedy request beside idle slots takes the greedy
    sampler mode (one graph signature on the card) and draws nothing."""
    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="tiny-llama-debug", dtype="float32", max_model_len=256,
        max_batch_size=4, device="cpu")
    runner = engine.worker.model_runner
    seen = []
    launch = runner._launch

    def spy(inputs, n_pre, mode):
        seen.append((mode, inputs.temperatures.tolist()))
        return launch(inputs, n_pre, mode)
    runner._launch = spy
    state = runner._generator.get_state()
    drain(engine, SamplingParams, {"r": list(range(1, 40))}, 3)
    assert seen and all(m == ts.GREEDY and t == [0.0] * 4 for m, t in seen)
    assert torch.equal(runner._generator.get_state(), state)
    engine.cleanup()
    fresh_metrics()


# the workloads of tests/test_e2e.py::test_engine_matches_dense_reference
E2E = [("fa_vattn", "sarathi", "tiny-llama-debug"),
       ("fa_vattn", "vllm", "tiny-llama-debug"),
       ("fa_vattn_64kb", "sarathi", "tiny-llama-debug"),
       ("fa_paged_128", "sarathi", "tiny-llama-debug"),
       ("fa_pod", "sarathi", "tiny-llama-debug"),
       ("fa_vattn", "sarathi", "tiny-d64-debug"),
       ("fa_vattn_megacache", "sarathi", "tiny-llama-debug"),
       ("fi_unpaged", "sarathi", "tiny-llama-debug")]
_JAX_TOKENS = {}


def _jax_async(model):
    """The JAX async engine (fa_vattn, sarathi) on the e2e prompts: its
    greedy tokens and weights; the JAX engines of the other workloads give
    the same tokens (tests/test_e2e.py holds each to the same dense
    reference), so one run per model serves every workload."""
    if model not in _JAX_TOKENS:
        fresh_metrics()
        engine = JaxLLMEngine.from_engine_args(
            **_kw("fa_vattn", "sarathi", model), enable_async_execution=True)
        tokens = drain(engine, JaxSamplingParams, _prompts(), 6)
        params = jax.tree.map(np.asarray, engine.worker.model_runner.params)
        engine.cleanup()
        fresh_metrics()
        _JAX_TOKENS[model] = (tokens, params)
    return _JAX_TOKENS[model]


def _kw(backend, scheduler, model):
    return dict(model=model, dtype="float32", attention_backend=backend,
                scheduler_type=scheduler, max_model_len=512,
                max_batch_size=4, max_num_seqs=4, chunk_size=128,
                gpu_memory_utilization=0.9)


def _prompts():
    rng = np.random.default_rng(5)
    return {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
            for i, n in enumerate([200, 37])}


@pytest.mark.parametrize("backend,scheduler,model", E2E)
def test_async_engine_matches_sync_and_jax(backend, scheduler, model,
                                           monkeypatch):
    """The async engine with the lag of a card (``lag_on_the_cpu``)."""
    expect, np_params = _jax_async(model)
    lag_on_the_cpu(monkeypatch)
    got = {}
    for async_mode in (True, False):
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            **_kw(backend, scheduler, model), load_format="zero",
            device="cpu", enable_async_execution=async_mode)
        engine.worker.model_runner.params = params_from_jax(np_params)
        got[async_mode] = drain(engine, SamplingParams, _prompts(), 6)
        assert engine.metrics_store.num_preempted == 0
        engine.cleanup()
    fresh_metrics()
    assert got[True] == got[False] == expect


# --------------- pure host-side pending-token machinery ---------------- #
def _mk_seq(**sp):
    return Sequence("x", None, [1, 2, 3], 16, eos_token_id=9,
                    arrival_time=0.0,
                    sampling_params=SP(temperature=0.0, max_tokens=4, **sp))


def test_pending_token_lifecycle():
    seq = _mk_seq(ignore_eos=True)
    seq.update_prompt_tokens_processed(3)
    seq.append_pending_token()
    seq.append_pending_token()
    assert seq.get_len() == 5 and seq.num_pending_tokens == 2
    assert seq.get_resolved_output_token_ids() == []
    i0 = seq.resolve_pending_token(11)
    assert i0 == 0 and seq.output_token_ids[0] == 11
    i1 = seq.resolve_pending_token(12)
    assert i1 == 1 and seq.get_resolved_output_token_ids() == [11, 12]


def test_length_stop_at_dispatch():
    seq = _mk_seq(ignore_eos=True)
    seq.update_prompt_tokens_processed(3)
    for _ in range(4):
        seq.append_pending_token()
        seq.check_length_stop()
    assert seq.get_status() == SequenceStatus.FINISHED_LENGTH_CAPPED


def test_eos_truncation_invalidates_speculative_tail():
    seq = _mk_seq(ignore_eos=False)
    seq.update_prompt_tokens_processed(3)
    gen0 = seq.generation
    for _ in range(3):
        seq.append_pending_token()
    seq.resolve_pending_token(5)
    idx = seq.resolve_pending_token(9)  # EOS value lands at index 1
    seq.truncate_and_finish(idx, SequenceStatus.FINISHED_STOPPED)
    assert seq.get_output_token_ids() == [5, 9]
    assert seq.num_pending_tokens == 0
    assert seq.generation == gen0 + 1
    assert seq.is_finished()


def test_preemption_drops_pending():
    seq = _mk_seq(ignore_eos=True)
    seq.update_prompt_tokens_processed(3)
    seq.set_status(SequenceStatus.RUNNING)
    seq.append_pending_token()
    seq.resolve_pending_token(7)
    seq.append_pending_token()
    seq.reset_for_recompute()
    # resolved token folds into the prompt; the in-flight one is dropped
    assert seq.prompt_token_ids == [1, 2, 3, 7]
    assert seq.output_token_ids == []
    assert seq.num_pending_tokens == 0


# ------------------------------ sampler -------------------------------- #
def sample_tokens_device_mode(logits, temperatures, top_p, top_k,
                              generator=None):
    """The port's sampler before it took a host mode: it branched on the
    device data (the reference the host-mode sampler is held to)."""
    B, V = logits.shape
    greedy = temperatures < 1e-5
    argmax = torch.argmax(logits, dim=-1)
    if bool(greedy.all()):
        return argmax.to(torch.int32)
    temps = torch.where(greedy, torch.ones_like(temperatures), temperatures)
    scaled = logits / temps[:, None]
    need_filter = (~greedy) & (((top_k > 0) & (top_k < V)) | (top_p < 1.0))
    if bool(need_filter.any()):
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        k = torch.where(top_k <= 0, torch.full_like(top_k, V), top_k)
        kth = torch.gather(sorted_logits, 1,
                           (k[:, None] - 1).clamp(0, V - 1).long())
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep = (cum - sorted_probs) < top_p[:, None]
        thresh = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(greedy, argmax, sampled).to(torch.int32)


# (temperatures, top_p, top_k, the mode they give)
MIXES = {
    "greedy": ([0.0] * 6, [1.0] * 6, [-1] * 6, ts.GREEDY),
    "temperature": ([0.0, 0.7, 1.0, 1.3, 0.0, 2.0], [1.0] * 6, [-1] * 6,
                    ts.SAMPLE),
    "top_k": ([0.0, 0.8, 1.0, 0.8, 1.0, 0.0], [1.0] * 6,
              [-1, 5, 1, -1, 40, 3], ts.FILTER),
    "top_p": ([0.9, 0.0, 1.0, 0.5, 1.2, 1.0], [0.9, 1.0, 0.5, 1.0, 0.95, 0.1],
              [-1] * 6, ts.FILTER),
    "top_k_and_top_p": ([1.0, 0.0, 0.7, 1.0, 0.9, 1.1],
                        [0.8, 0.5, 1.0, 0.6, 0.9, 1.0],
                        [10, -1, 3, 0, 64, 1], ts.FILTER),
    "greedy_filter_only": ([0.0] * 6, [0.5] * 6, [3] * 6, ts.GREEDY),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_host_mode_sampler_equals_device_mode_sampler(mix):
    temps, top_p, top_k, mode = MIXES[mix]
    temps = np.asarray(temps, np.float32)
    top_p = np.asarray(top_p, np.float32)
    top_k = np.asarray(top_k, np.int32)
    V = 64
    assert ts.sampler_mode(temps, top_p, top_k, V) == mode
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(a) for a in (temps, top_p, top_k)]
    g_old = torch.Generator().manual_seed(4)
    g_new = torch.Generator().manual_seed(4)
    for _ in range(3):  # the generators advance alike, step after step
        logits = torch.from_numpy(
            (2 * rng.standard_normal((6, V))).astype(np.float32))
        old = sample_tokens_device_mode(logits, *args, g_old)
        new = ts.sample_tokens(logits, *args, mode, g_new)
        assert torch.equal(new, old)
    assert torch.equal(g_old.get_state(), g_new.get_state())


def test_host_mode_sampler_equals_jax_on_greedy():
    from vattention_tpu.model_executor.layers import sampler as js

    rng = np.random.default_rng(9)
    logits = rng.standard_normal((5, 300)).astype(np.float32)
    temps = np.zeros(5, np.float32)
    top_p = np.full(5, 0.7, np.float32)
    top_k = np.full(5, 4, np.int32)
    expect = np.asarray(js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_p),
        jnp.asarray(top_k), jax.random.PRNGKey(0)))
    mode = ts.sampler_mode(temps, top_p, top_k, 300)
    got = ts.sample_tokens(*(torch.from_numpy(a) for a in (
        logits, temps, top_p, top_k)), mode=mode)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("n_pre", [0, 8])
def test_splice_prev_tokens_matches_jax(n_pre):
    from vattention_tpu.model_executor.model_runner import (
        ModelRunner as JaxModelRunner)
    from vattention_tpu.model_executor.step_inputs import (
        StepInputs as JaxStepInputs)
    from vattention_tpu_torch.model_executor.model_runner import ModelRunner
    from vattention_tpu_torch.model_executor.step_inputs import StepInputs

    B = 6
    rng = np.random.default_rng(2)
    token_ids = rng.integers(1, 1000, n_pre + B).astype(np.int32)
    use_prev = np.array([1, 0, 1, 1, 0, 0], bool)
    tok_buf = rng.integers(1, 1000, B).astype(np.int32)
    jax_inputs = JaxStepInputs(*[None] * len(JaxStepInputs._fields))._replace(
        token_ids=jnp.asarray(token_ids), use_prev_tok=jnp.asarray(use_prev))
    expect = JaxModelRunner._splice_prev_tokens(
        None, jax_inputs, jnp.asarray(tok_buf), n_pre).token_ids
    t = torch.from_numpy
    inputs = StepInputs(
        token_ids=t(token_ids), positions=None, append_rows=None,
        dec_seqlens=None, dec_tile_rows=None, sample_idx=None,
        temperatures=None, top_p=None, top_k=None,
        use_prev_tok=t(use_prev.astype(np.int32)))
    got = ModelRunner._splice_prev_tokens(inputs, t(tok_buf), n_pre).token_ids
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    # no slot waits: the inputs pass through
    assert ModelRunner._splice_prev_tokens(
        inputs._replace(use_prev_tok=None), t(tok_buf), n_pre
    ).token_ids is inputs.token_ids


def test_stager_reuses_its_buffers():
    """The stager's views for one layout are the same tensors every step
    (a captured graph reads their addresses), its ring of host buffers
    turns over, and each step's arrays arrive intact (float32 by bits)."""
    from vattention_tpu_torch.model_executor.step_inputs import InputStager

    stager = InputStager(torch.device("cpu"), ring=3)
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(5):
        arrays = dict(token_ids=rng.integers(0, 99, 13).astype(np.int32),
                      temperatures=rng.random(5).astype(np.float32),
                      use_prev_tok=rng.random(5) < 0.5)
        inputs = stager.stage(**arrays)
        np.testing.assert_array_equal(inputs.token_ids.numpy(),
                                      arrays["token_ids"])
        np.testing.assert_array_equal(inputs.temperatures.numpy(),
                                      arrays["temperatures"])
        np.testing.assert_array_equal(inputs.use_prev_tok.numpy(),
                                      arrays["use_prev_tok"])
        assert inputs.temperatures.dtype == torch.float32
        assert inputs.positions is None
        seen.append(inputs.token_ids.data_ptr())
    assert len(set(seen)) == 1
    assert sum(h is not None for h in stager._host) == 3
