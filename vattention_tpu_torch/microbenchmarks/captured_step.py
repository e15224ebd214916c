"""The captured serving step on the card (chip_smoke (h),
``tests/test_torch_cuda.py``).

``check_replays`` serves requests through an engine and, the first time
each greedy signature's graph is about to replay, runs the eager
``ModelRunner._step`` on the same staged inputs first, puts back the arena
rows and the token buffer it wrote, then replays the graph: the samples,
the arena rows the step writes and the token buffer must equal the eager
step's bit for bit.  ``check_step_does_not_sync`` runs whole async engine
steps (a prompt's, a mixed and a decode step, their signatures captured
first) under ``torch.cuda.set_sync_debug_mode("error")``.
``graph_report`` lists an engine's graphs.  ``next_step`` runs one
engine step and hands back what the runner launched it with: its staged
inputs, signature and graph (``scripts/profile_decode_step`` replays it).
Needs the card, but for ``next_step``, which on the CPU finds no graph.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vattention_tpu_torch.model_executor.layers.sampler import GREEDY


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def replay_matches_eager(runner, graph, inputs, n_pre: int,
                         mode: str) -> Dict[str, bool]:
    """Eager ``_step`` then the replay of ``graph`` on the same inputs and
    the same arena and token buffer; which outputs agree bit for bit."""
    kv = runner.cache_engine.kv_cache
    rows = inputs.append_rows[inputs.append_rows >= 0].long()
    before, tok0 = kv[:, :, :, rows].clone(), runner._tok_buf.clone()
    eager = runner._step(inputs, n_pre, mode).clone()
    eager_rows, eager_tok = kv[:, :, :, rows].clone(), runner._tok_buf.clone()
    kv[:, :, :, rows] = before
    runner._tok_buf.copy_(tok0)
    samples = runner.replay(graph)
    torch.cuda.synchronize()
    return {"samples": torch.equal(_bits(samples), _bits(eager)),
            "arena rows": torch.equal(_bits(kv[:, :, :, rows]),
                                      _bits(eager_rows)),
            "token buffer": torch.equal(runner._tok_buf, eager_tok)}


def check_replays(engine, requests, serve) -> Dict[tuple, Dict[str, bool]]:
    """Serve ``requests`` with ``serve(engine, requests)``; the first replay
    of each greedy signature is held against the eager step.  Returns
    {signature: {output: equal}}."""
    runner = engine.worker.model_runner
    launch = runner._launch
    checked: Dict[tuple, Dict[str, bool]] = {}

    def hooked(inputs, n_pre, mode):
        sig = runner.signature(inputs, n_pre, mode)
        graph = runner.graphs.get(sig)
        if graph is None or sig in checked or mode != GREEDY:
            return launch(inputs, n_pre, mode)
        checked[sig] = replay_matches_eager(runner, graph, inputs, n_pre,
                                            mode)
        return graph.samples

    runner._launch = hooked
    try:
        serve(engine, requests)
    finally:
        del runner._launch
    return checked


def check_step_does_not_sync(engine, lengths=(40, 150),
                             seed: int = 0) -> List[int]:
    """Run a prompt's step, then a second prompt's chunk beside the first's
    decode (a mixed step), then both decoding, once to capture their
    signatures and once more with each whole ``engine.step()`` under
    ``torch.cuda.set_sync_debug_mode("error")``: anything from
    ``_prepare_inputs`` through the replay to the next dispatch that waits
    for the device raises (an event wait, which ``resolve`` makes once the
    in-flight queue is full, is not a stream synchronization).  The
    requests are then served to their end.  Returns kernel A's launches
    in each checked step."""
    from vattention_tpu_torch import SamplingParams
    from vattention_tpu_torch.ops.cache_append import ROPE_KV_APPEND

    vocab = engine.worker.model_runner.model.arch.vocab_size
    rng = np.random.default_rng(seed)

    def add(seq_id, n):
        engine.add_request(
            prompt=None, seq_id=seq_id,
            prompt_token_ids=rng.integers(1, vocab, n).tolist(),
            sampling_params=SamplingParams(temperature=0.0, max_tokens=4,
                                           ignore_eos=True))

    def drain():
        while engine.has_unfinished_requests():
            engine.step()

    def pattern(tag, step):
        add(f"{tag}-a", lengths[0])
        step()
        add(f"{tag}-b", lengths[1])
        step()
        step()

    pattern("sync-warm", engine.step)
    drain()
    launches = []

    def checked():
        before = ROPE_KV_APPEND.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches.append(ROPE_KV_APPEND.launches - before)

    pattern("sync", checked)
    drain()
    return launches


def next_step(engine) -> dict:
    """Run one ``engine.step()`` and return the runner's launch of it:
    ``inputs`` (the stager's buffers, which hold this step's inputs until
    the next step is prepared), ``n_pre``, ``mode``, ``metas`` (the
    sequences' metadata it was prepared from) and ``graph``, its
    signature's graph (None where steps run eagerly, as on the CPU)."""
    runner = engine.worker.model_runner
    prepare, launch = runner._prepare_inputs, runner._launch
    got: dict = {}

    def hooked_prepare(metas):
        got["metas"] = metas
        return prepare(metas)

    def hooked_launch(inputs, n_pre, mode):
        samples = launch(inputs, n_pre, mode)
        got.update(inputs=inputs, n_pre=n_pre, mode=mode,
                   graph=runner.graphs.get(runner.signature(inputs, n_pre,
                                                            mode)))
        return samples

    runner._prepare_inputs, runner._launch = hooked_prepare, hooked_launch
    try:
        engine.step()
    finally:
        del runner._prepare_inputs, runner._launch
    return got


def graph_report(runner) -> List[dict]:
    """Each captured signature: (n_pre, POD flag, sampler mode), the
    capture's host seconds and the port kernels' launches per replay."""
    return [{"signature": sig, "capture_s": g.capture_s,
             "launches": {k.symbol: n for k, n in g.launches.items()}}
            for sig, g in runner.graphs.items()]
