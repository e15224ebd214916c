"""The serving entry points end to end: checkpoint, server, allocators.

chip_smoke's phase (s) runs ``run`` at yi-6b width on the card; the tests
run it with the tiny model on the CPU.  In order:

1. Draw the model's seeded dummy params on the device and write them as a
   local HF checkpoint (``checkpoint.write_checkpoint``: one file per layer
   and one for the embeddings and head, one layer on the host at a time)
   with a word-level tokenizer; load it back through
   ``weight_utils.load_safetensors`` and hold every tensor bit for bit.
   The write's and the load's seconds are timed.
2. Serve the checkpoint through ``OpenAIServer`` over ``AsyncLLMEngine``
   (the default allocator, the native core): ``n_requests`` completions
   of seeded prompts sent as token ids, two of them streamed (one with
   logprobs), and one chat request, all at once over HTTP
   (``serve_http.drive``), each for ``max_tokens`` greedy tokens.  The
   kernels' launch counts are zeroed just before and read just after.
3. Hold each completion's first token within ``tol`` logits of
   ``reference(model, params, prompt)``'s top.
4. Send the same prompts, in the same order, through a synchronous-API
   ``LLMEngine`` on the checkpoint with ``use_native_allocator=True`` and
   then ``False``: the tokens and the extent tables after every step must
   be identical.

Any failed check raises.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from vattention_tpu_torch.microbenchmarks.checkpoint import (
    words, write_checkpoint, write_word_tokenizer)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _flat(params) -> Dict[str, torch.Tensor]:
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return out


def round_trip(model, device, path, seed: int) -> dict:
    """Step 1: write the seeded params under ``path``, load them back and
    hold every tensor bit for bit."""
    from vattention_tpu_torch.config import ModelConfig
    from vattention_tpu_torch.model_executor.weight_utils import (
        load_safetensors)

    params = model.init_params(device, seed=seed)
    _sync(device)
    t0 = time.perf_counter()
    nbytes, n_hf = write_checkpoint(model, params, path)
    write_s = time.perf_counter() - t0
    write_word_tokenizer(path, model.arch.vocab_size)
    cfg = ModelConfig(model=str(path), load_format="safetensors",
                      dtype={v: k for k, v in DTYPES.items()}[model.dtype])
    if cfg.arch != model.arch:
        raise AssertionError(f"config.json reads back as {cfg.arch}, "
                             f"not {model.arch}")
    t0 = time.perf_counter()
    loaded = load_safetensors(model, cfg, device)
    _sync(device)
    load_s = time.perf_counter() - t0
    want, got = _flat(params), _flat(loaded)
    if sorted(want) != sorted(got):
        raise AssertionError(f"loaded {sorted(got)}, wrote {sorted(want)}")
    for name, t in want.items():
        g = got[name]
        if g.dtype != t.dtype or g.device != t.device or not torch.equal(
                g.view(torch.uint8), t.view(torch.uint8)):
            raise AssertionError(f"{name}: the loaded tensor is not the "
                                 "written one bit for bit")
    return dict(bytes=nbytes, write_s=write_s, load_s=load_s,
                tensors=len(want), hf_tensors=n_hf)


def _requests(prompts: Dict[str, List[int]], chat: List[int],
              max_tokens: int) -> List[dict]:
    reqs = []
    for i, (rid, ids) in enumerate(prompts.items()):
        body = {"model": "served", "prompt": ids, "max_tokens": max_tokens,
                "temperature": 0.0, "ignore_eos": True}
        if i < 2:
            body["stream"] = True
        if i == 1:
            body["logprobs"] = 2
        reqs.append({"id": rid, "body": body})
    reqs.append({"id": "chat", "path": "/v1/chat/completions", "body": {
        "model": "served", "max_tokens": max_tokens, "temperature": 0.0,
        "messages": [{"role": "user", "content": words(chat)}]}})
    return reqs


def time_steps(engine) -> dict:
    """Wrap ``engine.step`` to count its calls and the seconds spent in
    them (host work and waits for samples, on whichever thread steps)."""
    stats = {"steps": 0, "step_s": 0.0}
    step = engine.step

    def timed():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            stats["steps"] += 1
            stats["step_s"] += time.perf_counter() - t0

    engine.step = timed
    return stats


def serve_sync(engine, prompts: Dict[str, List[int]], max_tokens: int):
    """The prompts in order through ``engine``: greedy tokens, and the
    extent tables after every step."""
    from vattention_tpu_torch import SamplingParams

    for rid, ids in prompts.items():
        engine.add_request(None, SamplingParams(
            temperature=0.0, max_tokens=max_tokens, ignore_eos=True),
            prompt_token_ids=ids, seq_id=rid)
    ce = engine.worker.cache_engine
    out, tables = {}, []
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        tables.append([t.copy() for t in ce.get_batch_segments()])
        if len(tables) > 10_000:
            raise AssertionError("serving did not finish")
    return out, tables


def run(model_name: str, device, *, dtype: str = "bfloat16",
        backend: str = "fa_vattn_2mb", chunk: int = 512,
        max_model_len: int = 8192, batch: int = 8,
        lens: Sequence[int] = (1024, 4096), n_requests: int = 8,
        chat_len: int = 512, max_tokens: int = 32, seed: int = 0,
        kernels: Sequence = (), reference: Callable = None,
        tol: float = 0.25, log: Callable = print) -> dict:
    """Steps 1-4 (module docstring) for ``model_name``'s architecture.
    Returns the measurements and the launch counts of ``kernels``."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.engine.async_llm_engine import AsyncLLMEngine
    from vattention_tpu_torch.entrypoints.openai_server.api_server import (
        OpenAIServer)
    from vattention_tpu_torch.memory.native import NativeVAttentionAllocator
    from vattention_tpu_torch.microbenchmarks.serve_http import drive
    from vattention_tpu_torch.model_executor.models import get_model_class

    device = torch.device(device)
    arch = get_model_arch(model_name)
    model = get_model_class(arch.model_type)(arch, dtype=DTYPES[dtype])
    rng = np.random.default_rng(seed + 11)
    n_lens = rng.integers(lens[0], lens[1] + 1, n_requests)
    prompts = {f"q{i}": rng.integers(1, arch.vocab_size, int(n)).tolist()
               for i, n in enumerate(n_lens)}
    chat = rng.integers(1, arch.vocab_size, chat_len).tolist()
    path = tempfile.mkdtemp(prefix="vattn-checkpoint-")
    res: dict = {"model": model_name}
    try:
        res.update(round_trip(model, device, path, seed))
        _free(device)
        log(f"(s) checkpoint of {model_name} ({arch.num_layers} layers, "
            f"{dtype}): {res['hf_tensors']} HF tensors ({res['tensors']} "
            f"stacked params), {res['bytes'] / 1e9:.3f} GB in "
            f"{arch.num_layers + 1} files, written in "
            f"{res['write_s']:.3f} s ({res['bytes'] / 1e9 / res['write_s']:.3f}"
            f" GB/s, device to host to file), loaded in {res['load_s']:.3f} s "
            f"({res['bytes'] / 1e9 / res['load_s']:.3f} GB/s, file to "
            f"{device.type}); every tensor bit for bit")

        kw = dict(model=path, load_format="safetensors", dtype=dtype,
                  attention_backend=backend, scheduler_type="sarathi",
                  chunk_size=chunk, max_model_len=max_model_len,
                  max_batch_size=batch, max_num_seqs=batch,
                  device=device.type)
        t0 = time.perf_counter()
        engine = AsyncLLMEngine.from_engine_args(**kw, max_logprobs=2)
        res["engine_start_s"] = time.perf_counter() - t0
        ce = engine.engine.worker.cache_engine
        if type(getattr(ce, "allocator", None)) is not \
                NativeVAttentionAllocator:
            raise AssertionError("the server's engine does not run the "
                                 "native allocator core")
        server = OpenAIServer(engine, model_name, max_logprobs=2)
        requests = _requests(prompts, chat, max_tokens)
        stepped = time_steps(engine.engine)
        _sync(device)
        for k in kernels:
            k.launches = 0
        moves0 = ce.pending_moves
        t0 = time.perf_counter()
        outs = drive(server, requests)
        _sync(device)
        wall = time.perf_counter() - t0
        counts = {k.symbol: k.launches for k in kernels}
        res.update(counts=counts, moves=ce.pending_moves - moves0, wall_s=wall,
                   steps=stepped["steps"], step_s=stepped["step_s"])
        for rid, o in outs.items():
            if len(o["tokens"]) != max_tokens or o["finish_reason"] != "length":
                raise AssertionError(
                    f"(s) {rid}: {len(o['tokens'])} tokens, finish "
                    f"{o['finish_reason']!r}, not {max_tokens} and 'length'")
        lps = outs["q1"]["logprobs"]["token_logprobs"]
        if len(lps) != max_tokens or not all(x <= 0.0 for x in lps):
            raise AssertionError(f"(s) q1's logprobs: {lps}")
        n_prompt = sum(len(p) for p in prompts.values()) + \
            outs["chat"]["usage"]["prompt_tokens"]
        n_gen = max_tokens * len(outs)
        ttft = sorted(outs[r]["first_s"] for r in ("q0", "q1"))
        res.update(requests=len(outs), prompt_tokens=n_prompt,
                   generated_tokens=n_gen, requests_per_s=len(outs) / wall,
                   processed_tok_s=(n_prompt + n_gen) / wall,
                   ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1])
        log(f"(s) served {len(outs)} requests over HTTP ({n_requests} "
            f"completions of {n_lens.tolist()} prompt tokens, 2 streamed, "
            f"and a chat of {outs['chat']['usage']['prompt_tokens']} "
            f"templated tokens), {max_tokens} tokens each, in {wall:.3f} s; "
            f"{res['steps']} engine steps, {res['step_s']:.3f} s inside "
            f"them; engine start {res['engine_start_s']:.3f} s; launches: "
            + ", ".join(f"{s} {n}" for s, n in counts.items())
            + f"; the allocator planned {res['moves']} block moves")

        # 3: first tokens against the reference
        runner = engine.engine.worker.model_runner
        gaps = {}
        if reference is not None:
            with torch.no_grad():
                for rid, ids in prompts.items():
                    logits = reference(runner.model, runner.params, ids)
                    tok = outs[rid]["tokens"][0]
                    gaps[rid] = float(logits.max() - logits[tok])
                    log(f"(s) {rid} ({len(ids)} tokens): first token {tok}, "
                        f"reference top {int(logits.argmax())}, logit gap "
                        f"{gaps[rid]:.5f} (tolerance {tol})")
                    if not gaps[rid] <= tol:
                        raise AssertionError(f"(s) {rid}: logit gap "
                                             f"{gaps[rid]}")
        res["gaps"] = gaps
        engine.shutdown()
        del engine, server, runner, ce
        _free(device)

        # 4: the two allocators on the same prompts
        runs = {}
        for native in (True, False):
            eng = LLMEngine.from_engine_args(**kw, use_native_allocator=native)
            stepped = time_steps(eng)
            _sync(device)
            t0 = time.perf_counter()
            runs[native] = serve_sync(eng, prompts, max_tokens)
            _sync(device)
            res[f"sync_{'native' if native else 'python'}"] = dict(
                wall_s=time.perf_counter() - t0, **stepped)
            eng.cleanup()
            del eng
            _free(device)
        (tok_n, ext_n), (tok_p, ext_p) = runs[True], runs[False]
        if tok_n != tok_p:
            raise AssertionError("(s) the native and the Python allocator "
                                 "give different tokens")
        if len(ext_n) != len(ext_p) or any(
                not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                for a, b in zip(ext_n, ext_p)):
            raise AssertionError("(s) the native and the Python allocator "
                                 "give different extent tables")
        same = sum(a == b for r in prompts
                   for a, b in zip(tok_n[r], outs[r]["tokens"]))
        res["same_as_server"] = same
        log(f"(s) synchronous-API LLMEngine, the same {n_requests} prompts "
            f"in order: native and Python allocators give identical tokens "
            f"and identical extent tables over {len(ext_n)} steps; {same} of "
            f"{n_requests * max_tokens} tokens equal the server's "
            "(information only: the server batched them as they arrived); "
            + "; ".join(
                f"{k[5:]} core {v['wall_s']:.3f} s wall, {v['steps']} steps, "
                f"{v['step_s']:.3f} s inside them"
                for k, v in res.items() if k.startswith("sync_")))
        return res
    finally:
        shutil.rmtree(path, ignore_errors=True)
