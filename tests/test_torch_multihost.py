"""Ranks as processes in the PyTorch port (counterpart of
tests/test_multihost.py).

Two processes, started through ``python -m
vattention_tpu_torch.parallel.multihost``, run one tp=2 engine on the CPU
(gloo) under ``serve_multihost``: the driver broadcasts the admissions, and
both processes must produce the same outputs, equal to those of the
single-process facade (``LLMEngine`` starting its own second rank) and of
the one-rank engine.  The control plane, the arrival times stamped once by
the driver, and the failures (a process group that cannot form, a rank
that raises) are held too: each raises in the parent, within its timeout,
and leaves no child running.  Ranks run on the card unless asked for the
CPU, so every test here asks; a facade started from another directory
reads a relative checkpoint on every rank.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vattention_tpu_torch import LLMEngine, SamplingParams
from vattention_tpu_torch.metrics.metrics_store import MetricsStore
from vattention_tpu_torch.parallel.multihost import (RequestControlPlane,
                                                     launch_ranks, run_ranks,
                                                     serve_multihost,
                                                     serve_requests)

ENGINE = dict(model="tiny-llama-debug", dtype="float32",
              attention_backend="fa_vattn", scheduler_type="sarathi",
              chunk_size=128, max_model_len=512, max_batch_size=4,
              max_num_seqs=4, gpu_memory_utilization=0.9,
              enable_async_execution=False)


def requests():
    """tests/test_multihost.py's three requests."""
    rng = np.random.default_rng(21)
    return [dict(prompt=None,
                 prompt_token_ids=rng.integers(1, 2000, n).tolist(),
                 sampling_params=SamplingParams(temperature=0.0, max_tokens=5,
                                                ignore_eos=True),
                 seq_id=f"mh{i}")
            for i, n in enumerate([90, 50, 70])]


def serve_in_process(engine):
    for kw in requests():
        engine.add_request(**kw)
    out, steps = {}, 0
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                out[o.seq_id] = o.token_ids
        steps += 1
        assert steps < 300
    engine.cleanup()
    return out


def test_two_process_serving_matches_the_single_process_facade():
    out = run_ranks(serve_requests, 2, dict(runs=[dict(
        engine_args=dict(ENGINE, tensor_parallel_size=2),
        requests=requests())]), device="cpu", timeout_s=150)
    r0, r1 = out[0][0], out[1][0]
    # every process computed the same outputs
    assert r0["outputs"] == r1["outputs"]
    assert sorted(r0["outputs"]) == ["mh0", "mh1", "mh2"]
    assert all(len(v) == 5 for v in r0["outputs"].values())
    assert (r0["backend"], r1["backend"]) == ("gloo", "gloo")
    assert (r0["coords"], r1["coords"]) == ((0, 0, 0), (0, 0, 1))
    # the rank-local arena: one of tiny-llama-debug's two kv heads each
    assert r0["arena"][:3] == (2, 2, 1)
    assert r0["graphs"] == 0

    MetricsStore._instance = None
    facade = serve_in_process(LLMEngine.from_engine_args(
        **ENGINE, tensor_parallel_size=2, device="cpu"))
    MetricsStore._instance = None
    one = serve_in_process(LLMEngine.from_engine_args(**ENGINE,
                                                      device="cpu"))
    MetricsStore._instance = None
    assert r0["outputs"] == facade == one, (r0["outputs"], facade, one)
    assert not dist.is_initialized()


def test_a_facade_started_elsewhere_reads_a_relative_checkpoint(
        tmp_path, monkeypatch):
    """A tp=2 engine started from a directory that names its checkpoint by
    a relative path: the second rank, a child, inherits the directory and
    reads the same weights, so the tokens equal the one-rank engine's."""
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.microbenchmarks.checkpoint import (
        write_checkpoint)
    from vattention_tpu_torch.model_executor.models.llama import (
        LlamaForCausalLM)

    model = LlamaForCausalLM(get_model_arch("tiny-llama-debug"),
                             dtype=torch.float32)
    write_checkpoint(model, model.init_params(torch.device("cpu"), seed=7),
                     tmp_path / "ckpt")
    monkeypatch.chdir(tmp_path)
    kw = dict(ENGINE, model="ckpt", load_format="safetensors", device="cpu")
    MetricsStore._instance = None
    facade = serve_in_process(LLMEngine.from_engine_args(
        **kw, tensor_parallel_size=2))
    MetricsStore._instance = None
    one = serve_in_process(LLMEngine.from_engine_args(**kw))
    MetricsStore._instance = None
    assert facade == one, (facade, one)
    assert not dist.is_initialized()


def test_ranks_run_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    """With no CUDA device, ranks that were not asked to run on the CPU
    raise before any child starts: ``run_ranks``, ``init_multihost`` and
    the rank entry point all default to the card."""
    import pickle

    from vattention_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(rank_that_raises, 2, {}, timeout_s=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                                 timeout_s=10)
    (tmp_path / "payload.pkl").write_bytes(pickle.dumps({}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.main(["--run-dir", str(tmp_path), "--num-processes", "1",
                        "--process-id", "0", "--call",
                        f"{__name__}:rank_that_raises"])
    assert not dist.is_initialized()


def test_control_plane_ticks_in_order():
    """The driver's admissions reach the follower at the tick they were
    submitted for; a follower out of step raises."""
    store = dist.HashStore()
    planes = {}

    def driver():
        planes[0] = RequestControlPlane(0, 2, store=store, timeout_s=30)

    t = threading.Thread(target=driver)
    t.start()
    follower = RequestControlPlane(1, 2, store=store, timeout_s=30)
    t.join()
    drv = planes[0]
    # the driver listens on the loopback interface only
    assert drv._server.getsockname()[0] == "127.0.0.1"
    drv.submit(("add", {"seq_id": "a"}))
    assert drv.tick(0) == [("add", {"seq_id": "a"})]
    drv.tick(1, stop=True)
    assert follower.wait_tick(0) == ([("add", {"seq_id": "a"})], False)
    assert follower.wait_tick(1) == ([], True)
    drv.tick(5)
    with pytest.raises(RuntimeError, match="out of step"):
        follower.wait_tick(2)
    drv.close()
    with pytest.raises(ConnectionError):
        follower.wait_tick(3)
    follower.close()


class _Recorder:
    """A control plane and an engine that record what the driver sends."""

    is_driver = True

    def __init__(self):
        self.sent = []
        self.added = []
        self.steps = 0

    def submit(self, payload):
        self.sent.append(payload)

    def tick(self, it, stop=False):
        batch, self.sent = self.sent, []
        return batch

    def add_request(self, **kw):
        self.added.append(kw)

    def has_unfinished_requests(self):
        return self.steps < 2

    def step(self):
        self.steps += 1
        return []


def test_the_driver_stamps_arrival_times_once():
    """Every process admits a request with the driver's arrival time and
    sequence id (a follower's clock never stamps it)."""
    rec = _Recorder()
    t0 = time.monotonic()
    serve_multihost(rec, rec, requests=[
        dict(prompt=None, prompt_token_ids=[1, 2], seq_id="x",
             sampling_params=SamplingParams()),
        dict(prompt=None, prompt_token_ids=[3], seq_id="y",
             arrival_time=5.0, sampling_params=SamplingParams())])
    assert [kw["seq_id"] for kw in rec.added] == ["x", "y"]
    assert t0 <= rec.added[0]["arrival_time"] <= time.monotonic()
    assert rec.added[1]["arrival_time"] == 5.0


def rank_that_raises(*, device, store):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # rank 0 waits here for a rank that never comes


def test_a_rank_that_raises_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(rank_that_raises, 2, {}, device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_a_group_that_cannot_form_raises():
    """Rank 1 of 2 alone: its process group start times out and raises; the
    parent's join reports the failure (no downgrade, no hang)."""
    ranks = launch_ranks(rank_that_raises, 2, {}, device="cpu",
                         first_rank=1, timeout_s=3)
    try:
        with pytest.raises(RuntimeError, match="failed"):
            ranks.join(timeout_s=120)
        assert all(p.poll() is not None for p in ranks.procs.values())
    finally:
        ranks.kill()
        ranks.remove()


def test_parallel_serving_on_the_cpu(capsys):
    """``microbenchmarks/parallel_serving`` at the tiny model's size: its
    float32 check passes on every layout (gloo ranks, no graphs), every
    layout's tokens equal the one-rank layout's, and s0's first token is
    within the tolerance of the dense reference."""
    import json

    from vattention_tpu_torch.microbenchmarks import parallel_serving

    assert parallel_serving.main(["--device", "cpu", "--passes", "1",
                                  "--layouts", "tp2,pp2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    checks = [r for r in lines if "check" in r]
    served = [r for r in lines if "check" not in r]
    # the one-rank layout runs first, asked for or not
    assert [r["layout"] for r in checks] == ["one", "tp2", "pp2"]
    assert [r["layout"] for r in served] == ["one", "tp2", "pp2"]
    for r in checks:
        assert r["tokens_equal_to_one"] is True and r["backend"] == "gloo"
        assert sum(r["graphs"]) == 0
    for r in served:
        assert r["backend"] == "gloo" and r["graphs"] == [0] * (
            r["pp"] * r["tp"])
        assert r["tokens_equal_to_one"] == r["generated"] == 8
        assert r["s0_logit_gap"] <= r["logit_gap_tol"] == 0.25
