"""The port's AsyncLLMEngine and OpenAI server, on the CPU, tiny model.

Twins of the nine tests of ``tests/test_openai_server.py`` (routes, the
API key, token-id prompts, streaming, logprobs against ``max_logprobs``,
``n``, ``best_of``, ``include_usage``, tokenizer-less chat) on the port's
server over its AsyncLLMEngine (device="cpu", float32).  Then the JAX
server and the port's, on the same weights (``params_from_jax``), must give
the same greedy completions: token ids, text, ``n`` and ``best_of``
choices, and logprobs within 1e-4.  The async engine delivers a request's
last tokens while steps are in flight (a card's lag forced on the CPU by
``StepHandle.is_ready = False``), steps on one dedicated thread, restarts
its loop in a new event loop, and refuses a prompt past max_model_len on
that request's stream alone.  A server with a word-level tokenizer answers
chat.  The server's ``main`` and the offline example run with
``--device cpu`` in subprocesses.
"""

import asyncio
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from vattention_tpu.engine.async_llm_engine import \
    AsyncLLMEngine as JaxAsyncLLMEngine
from vattention_tpu.entrypoints.openai_server.api_server import \
    OpenAIServer as JaxOpenAIServer
from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.engine.async_llm_engine import AsyncLLMEngine
from vattention_tpu_torch.entrypoints.openai_server.api_server import \
    OpenAIServer
from vattention_tpu_torch.microbenchmarks.checkpoint import (
    parse_words, words, write_word_tokenizer)
from vattention_tpu_torch.model_executor.model_runner import StepHandle
from vattention_tpu_torch.model_executor.weight_utils import params_from_jax

from test_torch_engine import fresh_metrics

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(model="tiny-llama-debug", dtype="float32",
                 attention_backend="fa_vattn", scheduler_type="sarathi",
                 max_model_len=512, max_batch_size=4, max_num_seqs=4,
                 chunk_size=128, max_logprobs=3)


@pytest.fixture(scope="module")
def engine():
    fresh_metrics()
    eng = AsyncLLMEngine.from_engine_args(**ENGINE_KW, device="cpu")
    yield eng
    eng.shutdown()
    fresh_metrics()


def _run(engine, api_key, fn, server_cls=OpenAIServer):
    async def body():
        server = server_cls(engine, "tiny-llama-debug", api_key,
                            max_logprobs=3)
        client = TestClient(TestServer(server.app()))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(body())


def _events(raw):
    return [line[len("data: "):] for line in raw.splitlines()
            if line.startswith("data: ")]


# -- the nine twins of tests/test_openai_server.py ----------------------- #
def test_health_and_models(engine):
    async def fn(client):
        r = await client.get("/health")
        assert r.status == 200
        r = await client.get("/v1/models")
        data = await r.json()
        assert data["data"][0]["id"] == "tiny-llama-debug"

    _run(engine, None, fn)


def test_api_key_middleware(engine):
    async def fn(client):
        r = await client.get("/v1/models")
        assert r.status == 401
        r = await client.get(
            "/v1/models", headers={"Authorization": "Bearer sk-test"})
        assert r.status == 200
        r = await client.get("/health")
        assert r.status == 200  # only /v1 is guarded

    _run(engine, "sk-test", fn)


def test_completion_token_ids(engine):
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(5, 37)),
            "max_tokens": 4, "temperature": 0.0, "ignore_eos": True})
        assert r.status == 200, await r.text()
        data = await r.json()
        toks = json.loads(data["choices"][0]["text"])
        assert len(toks) == 4 and all(isinstance(t, int) for t in toks)
        assert data["usage"] == {"prompt_tokens": 32, "completion_tokens": 4,
                                 "total_tokens": 36}

    _run(engine, None, fn)


def test_completion_streaming(engine):
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(7, 41)),
            "max_tokens": 3, "temperature": 0.0, "ignore_eos": True,
            "stream": True})
        assert r.status == 200
        events = _events((await r.read()).decode())
        assert events[-1] == "[DONE]"
        payloads = [json.loads(e) for e in events[:-1]]
        assert payloads
        assert payloads[-1]["choices"][0]["finish_reason"] == "length"
        assert all(p["choices"][0]["finish_reason"] is None
                   for p in payloads[:-1])

    _run(engine, None, fn)


def test_completion_logprobs(engine):
    """``logprobs: k`` gives each token's logprob and its top-k; greedy,
    so the chosen token's logprob is the best alternative's."""
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(9, 43)),
            "max_tokens": 3, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 2})
        assert r.status == 200, await r.text()
        lp = (await r.json())["choices"][0]["logprobs"]
        assert len(lp["tokens"]) == 3 and len(lp["token_logprobs"]) == 3
        for x, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
            assert isinstance(x, float) and x <= 0.0
            assert 1 <= len(top) <= 2
            assert abs(x - max(top.values())) < 1e-4
        # over the server's --max-logprobs -> 400
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": [1, 2, 3],
            "max_tokens": 1, "logprobs": 9})
        assert r.status == 400

    _run(engine, None, fn)


def test_completion_n_choices(engine):
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(11, 45)),
            "max_tokens": 2, "temperature": 0.0, "ignore_eos": True, "n": 2})
        assert r.status == 200, await r.text()
        data = await r.json()
        assert [c["index"] for c in data["choices"]] == [0, 1]
        assert data["choices"][0]["text"] == data["choices"][1]["text"]
        assert data["usage"]["completion_tokens"] == 4

    _run(engine, None, fn)


def test_completion_best_of(engine):
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(13, 47)),
            "max_tokens": 2, "temperature": 0.8, "ignore_eos": True,
            "n": 1, "best_of": 3})
        assert r.status == 200, await r.text()
        data = await r.json()
        assert len(data["choices"]) == 1
        # usage counts every sampled candidate (OpenAI semantics)
        assert data["usage"]["completion_tokens"] == 6

    _run(engine, None, fn)


def test_stream_include_usage(engine):
    async def fn(client):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(15, 49)),
            "max_tokens": 2, "temperature": 0.0, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}})
        assert r.status == 200
        events = _events((await r.read()).decode())
        assert events[-1] == "[DONE]"
        last = json.loads(events[-2])
        assert last["choices"] == []
        assert last["usage"]["completion_tokens"] == 2

    _run(engine, None, fn)


def test_chat_completion(engine):
    async def fn(client):
        r = await client.post("/v1/chat/completions", json={
            "model": "tiny-llama-debug",
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 2, "temperature": 0.0})
        # a tokenizer-less server cannot encode the templated string
        assert r.status == 400
        data = await r.json()
        assert "tokenizer-less" in data["error"]["message"]

    _run(engine, None, fn)


# -- the JAX server and the port's on the same weights ------------------- #
REQUESTS = [
    {"prompt": list(range(5, 37)), "max_tokens": 4, "logprobs": 2},
    {"prompt": list(range(100, 180)), "max_tokens": 3, "n": 2},
    {"prompt": list(range(40, 90)), "max_tokens": 3, "best_of": 2},
    {"prompt": list(range(7, 41)), "max_tokens": 3, "logprobs": 1,
     "stream": True},
]


async def _ask_all(client):
    """Every REQUESTS entry, greedy, at once; the JSON bodies (the stream's
    chunks joined per choice)."""
    async def one(req):
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "temperature": 0.0,
            "ignore_eos": True, **req})
        assert r.status == 200, await r.text()
        if not req.get("stream"):
            return await r.json()
        chunks = [json.loads(e) for e in _events((await r.read()).decode())
                  if e != "[DONE]"]
        tokens = [t for c in chunks for t in c["choices"][0]["logprobs"][
            "tokens"]]
        lps = [x for c in chunks for x in c["choices"][0]["logprobs"][
            "token_logprobs"]]
        return {"tokens": tokens, "token_logprobs": lps,
                "finish": chunks[-1]["choices"][0]["finish_reason"]}

    return await asyncio.gather(*[one(req) for req in REQUESTS])


def _same_completions(got, expect):
    for g, e in zip(got, expect):
        if "choices" not in e:  # the streamed request
            assert g["tokens"] == e["tokens"] and g["finish"] == e["finish"]
            np.testing.assert_allclose(g["token_logprobs"],
                                       e["token_logprobs"], atol=1e-4)
            continue
        assert g["usage"] == e["usage"]
        assert len(g["choices"]) == len(e["choices"])
        for gc, ec in zip(g["choices"], e["choices"]):
            assert (gc["index"], gc["text"], gc["finish_reason"]) == (
                ec["index"], ec["text"], ec["finish_reason"])
            if ec["logprobs"] is None:
                assert gc["logprobs"] is None
                continue
            gl, el = gc["logprobs"], ec["logprobs"]
            assert gl["tokens"] == el["tokens"]
            np.testing.assert_allclose(gl["token_logprobs"],
                                       el["token_logprobs"], atol=1e-4)
            for gt, et in zip(gl["top_logprobs"], el["top_logprobs"]):
                assert list(gt) == list(et)
                np.testing.assert_allclose(list(gt.values()),
                                           list(et.values()), atol=1e-4)


def test_port_server_matches_the_jax_server():
    """The same greedy completions from both servers on one set of
    weights: the token ids (the text of a tokenizer-less server), the
    ``n`` and ``best_of`` choices, the usage, and the logprobs and top
    logprobs within 1e-4, streamed and not."""
    from vattention_tpu.metrics.metrics_store import MetricsStore

    fresh_metrics()
    jax_engine = JaxAsyncLLMEngine.from_engine_args(**ENGINE_KW)
    np_params = jax.tree.map(np.asarray,
                             jax_engine.engine.worker.model_runner.params)
    expect = _run(jax_engine, None, _ask_all, JaxOpenAIServer)
    jax_engine.engine.cleanup()
    MetricsStore._instance = None

    fresh_metrics()
    port = AsyncLLMEngine.from_engine_args(**ENGINE_KW, load_format="zero",
                                           device="cpu")
    port.engine.worker.model_runner.params = params_from_jax(np_params)
    try:
        got = _run(port, None, _ask_all)
    finally:
        port.shutdown()
    fresh_metrics()
    _same_completions(got, expect)
    assert json.loads(got[0]["choices"][0]["text"])  # token ids, parsed


# -- the async engine ---------------------------------------------------- #
def _generate_all(engine, prompts, max_tokens):
    """Every prompt through ``engine.generate`` at once; each request's
    outputs in order."""
    async def one(seq_id, ids):
        params = SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                ignore_eos=True)
        return [o async for o in engine.generate(
            None, params, request_id=seq_id, prompt_token_ids=ids)]

    async def body():
        outs = await asyncio.gather(*[one(s, p) for s, p in prompts.items()])
        return dict(zip(prompts, outs))

    return asyncio.new_event_loop().run_until_complete(body())


def test_last_tokens_arrive_while_steps_are_in_flight(monkeypatch):
    """With every step's samples held back (a card's lag), the loop keeps
    stepping while steps are in flight and so delivers each request's
    last tokens: the sync engine's tokens, finished, nothing left in
    flight."""
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([200, 37])}
    fresh_metrics()
    sync = LLMEngine.from_engine_args(**ENGINE_KW, device="cpu",
                                      enable_async_execution=False)
    for seq_id, ids in prompts.items():
        sync.add_request(None, SamplingParams(temperature=0.0, max_tokens=6,
                                              ignore_eos=True),
                         prompt_token_ids=ids, seq_id=seq_id)
    expect = {}
    while sync.has_unfinished_requests():
        for o in sync.step():
            if o.finished:
                expect[o.seq_id] = o.token_ids
    sync.cleanup()

    monkeypatch.setattr(StepHandle, "is_ready", lambda self: False)
    fresh_metrics()
    eng = AsyncLLMEngine.from_engine_args(**ENGINE_KW, device="cpu")
    inflight = []
    step = eng.engine.step

    def counting_step():
        out = step()
        inflight.append(len(eng.engine.worker._inflight))
        return out

    eng.engine.step = counting_step
    try:
        outs = _generate_all(eng, prompts, 6)
        assert max(inflight) == eng.engine.max_inflight_steps
        assert not eng.engine.worker.has_inflight_steps()
        assert not eng.engine.has_unfinished_requests()
    finally:
        eng.shutdown()
    for seq_id, seq_outs in outs.items():
        assert seq_outs[-1].finished
        assert seq_outs[-1].token_ids == expect[seq_id]
        # the stream shows only resolved tokens, growing
        lens = [len(o.token_ids) for o in seq_outs]
        assert lens == sorted(lens) and lens[-1] == 6


def test_the_engine_steps_on_one_thread_and_restarts_in_a_new_loop():
    """Every step (and every admission) runs on the engine's one worker
    thread, never the event loop's; a second event loop gets a new
    background loop that serves as the first did."""
    fresh_metrics()
    eng = AsyncLLMEngine.from_engine_args(**ENGINE_KW, device="cpu")
    threads = set()
    step, add = eng.engine.step, eng.engine.add_request

    def record(fn):
        def wrapped(*args, **kwargs):
            threads.add(threading.current_thread().name)
            return fn(*args, **kwargs)
        return wrapped

    eng.engine.step = record(step)
    eng.engine.add_request = record(add)
    prompts = {"a": list(range(3, 70)), "b": list(range(9, 40))}
    try:
        first = _generate_all(eng, prompts, 3)
        task = eng._background_task
        second = _generate_all(eng, {f"{k}2": v for k, v in prompts.items()},
                               3)
        assert eng._background_task is not task
    finally:
        eng.shutdown()
    assert len(threads) == 1
    assert next(iter(threads)).startswith("vattn-engine")
    for k in prompts:
        assert first[k][-1].token_ids == second[k + "2"][-1].token_ids
        assert len(first[k][-1].token_ids) == 3


def test_a_refused_prompt_ends_only_its_own_request(engine):
    """A prompt of max_model_len tokens is refused on its own stream (the
    server answers 400); a request beside it completes."""
    async def fn(client):
        long_req = client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": [7] * 512,
            "max_tokens": 2, "temperature": 0.0})
        short_req = client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": list(range(5, 30)),
            "max_tokens": 2, "temperature": 0.0, "ignore_eos": True})
        r_long, r_short = await asyncio.gather(long_req, short_req)
        assert r_long.status == 400
        assert "max_model_len" in (await r_long.json())["error"]["message"]
        assert r_short.status == 200
        assert (await r_short.json())["usage"]["completion_tokens"] == 2

    _run(engine, None, fn)


def test_chat_with_a_tokenizer(tmp_path):
    """With a tokenizer (word-level: token i is the word t<i>) the server
    templates and encodes chat, and answers in text, streamed or not."""
    write_word_tokenizer(tmp_path, 2048)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 128,
        "hidden_size": 256, "intermediate_size": 688, "vocab_size": 2048,
        "max_position_embeddings": 8192}))
    fresh_metrics()
    eng = AsyncLLMEngine.from_engine_args(
        **{**ENGINE_KW, "model": str(tmp_path)}, device="cpu")

    async def fn(client):
        body = {"model": "tiny-llama-debug", "max_tokens": 5,
                "temperature": 0.0,
                "messages": [{"role": "user", "content": words(range(3, 60))}]}
        r = await client.post("/v1/chat/completions", json=body)
        assert r.status == 200, await r.text()
        data = await r.json()
        text = data["choices"][0]["message"]["content"]
        assert len(parse_words(text)) == 5
        assert data["usage"]["completion_tokens"] == 5
        r = await client.post("/v1/chat/completions",
                              json={**body, "stream": True})
        chunks = [json.loads(e) for e in _events((await r.read()).decode())
                  if e != "[DONE]"]
        streamed = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
        assert parse_words(streamed) == parse_words(text)
        # a text prompt encodes through the tokenizer
        r = await client.post("/v1/completions", json={
            "model": "tiny-llama-debug", "prompt": words(range(3, 60)),
            "max_tokens": 5, "temperature": 0.0, "ignore_eos": True})
        assert (await r.json())["usage"]["prompt_tokens"] == 57

    try:
        _run(eng, None, fn)
    finally:
        eng.shutdown()
        fresh_metrics()


# -- the entry points as a user runs them --------------------------------- #
def test_api_server_main_serves_on_the_cpu():
    """``python -m ...api_server --device cpu`` answers a completion."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "vattention_tpu_torch.entrypoints.openai_server.api_server",
         "--device", "cpu", "--port", str(port), "--max-model-len", "256",
         "--max-batch-size", "2", "--max-logprobs", "1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                urllib.request.urlopen(url + "/health", timeout=5)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.5)
        req = urllib.request.Request(
            url + "/v1/completions", method="POST",
            headers={"Content-Type": "application/json"},
            data=json.dumps({"model": "tiny-llama-debug",
                             "prompt": list(range(5, 40)), "max_tokens": 3,
                             "temperature": 0.0, "ignore_eos": True}).encode())
        data = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert len(json.loads(data["choices"][0]["text"])) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_offline_example_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "vattention_tpu_torch.examples.offline_inference",
         "--device", "cpu", "--num-requests", "2", "--prompt-len", "60",
         "--max-tokens", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: 2 requests" in res.stdout
    assert res.stdout.count("generated 4 tokens") == 2


def test_the_server_phase_on_the_cpu():
    """chip_smoke's phase (s) at the tiny model's size: the checkpoint's
    round trip bit for bit, the server's 4 completions (2 streamed, one
    with logprobs) and a chat over HTTP, each first token the float32
    dense reference's top, and the two allocators' identical tokens and
    extent tables."""
    import torch
    from chip_smoke import dense_logits
    from vattention_tpu_torch.microbenchmarks import server_phase
    from vattention_tpu_torch.ops.cache_append import ROPE_KV_APPEND
    from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
    from vattention_tpu_torch.ops.flash_prefill import PREFILL_ATTENTION

    def reference(model, params, ids):
        return dense_logits(model, params, ids, torch.device("cpu"))

    logged = []
    fresh_metrics()
    res = server_phase.run(
        "tiny-llama-debug", "cpu", dtype="float32", backend="fa_vattn",
        chunk=128, max_model_len=512, batch=4, lens=(60, 200), n_requests=4,
        chat_len=40, max_tokens=5, reference=reference, tol=1e-4,
        kernels=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION],
        log=logged.append)
    fresh_metrics()
    assert res["requests"] == 5 and res["generated_tokens"] == 25
    assert res["tensors"] == 9 and res["bytes"] > 0  # 6 stacked + 3
    # CPU tensors take the plain versions: no kernel launches
    assert set(res["counts"].values()) == {0}
    assert len(res["gaps"]) == 4
    assert res["ttft_max_s"] >= res["ttft_p50_s"] > 0
    assert any("identical extent tables" in line for line in logged)
