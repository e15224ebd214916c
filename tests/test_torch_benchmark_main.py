"""The port's benchmark entry point against the JAX package's, on the CPU.

``python -m vattention_tpu_torch.benchmark.main --test --device cpu``
through both of ``main()``'s routes: the argparse flags
(``run_from_args``) and the YAML config (``run_from_flat``, taken when a
flag names a ``default.yml`` key), each beside the JAX package's ``main
--test`` with the same flags: the same completed requests and token
totals (float32 tiny model, ``load_format="zero"`` in both).  Without a
GPU and without ``--device cpu`` the port raises.  Both packages'
``MetricsStore`` singletons are reset around every test.
"""

import argparse
import os
import shlex
import sys

import pytest
import torch

from vattention_tpu.benchmark import main as jax_main
from vattention_tpu_torch.benchmark import main as port_main


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
    in-flight queue is full, as on a card."""
    from vattention_tpu.model_executor.model_runner import (
        StepHandle as JaxStepHandle)
    from vattention_tpu_torch.model_executor.model_runner import StepHandle

    monkeypatch.setattr(StepHandle, "is_ready", lambda self: False)
    monkeypatch.setattr(JaxStepHandle, "is_ready", lambda self: False)


def _main(module, argv, monkeypatch):
    """Run ``module.main()`` with ``argv``; -> (entry taken, summary)."""
    taken = {}
    for name in ("run_from_args", "run_from_flat"):
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda a, fn=fn, name=name: taken.setdefault(name, fn(a)))
    monkeypatch.setattr(sys, "argv", ["main", *argv])
    module.main()
    assert len(taken) == 1
    return next(iter(taken.items()))


@pytest.mark.parametrize("argv,entry", [
    (["--test"], "run_from_args"),
    (["--test", "--output_dir", "yaml_output"], "run_from_flat"),
])
def test_main_test_runs_through_both_entry_points(argv, entry, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    lag(monkeypatch)
    name, got = _main(port_main, [*argv, "--device", "cpu"], monkeypatch)
    assert name == entry
    ref_name, expect = _main(jax_main, argv, monkeypatch)
    assert ref_name == entry
    keys = ("completed_requests", "processed_tokens", "decode_tokens",
            "preemptions")
    assert got["totals"]["completed_requests"] == 2
    assert {k: got["totals"][k] for k in keys} == {
        k: expect["totals"][k] for k in keys}
    out = "yaml_output" if entry == "run_from_flat" else "benchmark_output"
    assert os.path.exists(tmp_path / out / "summary.json")


def test_main_without_a_gpu_raises(monkeypatch):
    """No CUDA device and no --device cpu: the engine raises, as it does
    everywhere in the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.run_from_args(port_main.add_args(
            argparse.ArgumentParser()).parse_args(["--test"]))


def _docstring_example():
    """The flags of the module docstring's example without ``--test``."""
    doc = port_main.__doc__.split("Examples:")[1]
    cmds = [" ".join(c.split()) for c in doc.replace("\\\n", " ")
            .strip().splitlines()]
    cmd = next(c for c in cmds if "--test" not in c)
    return shlex.split(cmd)[3:]


@pytest.mark.parametrize("extra,max_tokens", [([], 4096),
                                              (["--max-model-len", "2048"],
                                               2048)])
def test_the_docstring_example_builds_its_configs(extra, max_tokens):
    """Without ``--test`` and without ``--max-model-len`` the drawn lengths
    are clamped to the model's own context (yi-6b-200k's 200,000, so
    ``--max-tokens``' 4096 stands); the JAX package's ``run_from_args``
    raises a TypeError there before building anything."""
    argv = _docstring_example() + extra
    assert argv[:2] == ["--model", "yi-6b-200k"]
    args = port_main.add_args(argparse.ArgumentParser()).parse_args(argv)
    engine_kwargs, gen = port_main.configs_from_args(args)
    assert engine_kwargs["max_model_len"] == (2048 if extra else None)
    assert engine_kwargs["device"] == "cuda"
    assert (gen["max_tokens"], gen["num_requests"], gen["prefill_tokens"],
            gen["decode_tokens"]) == (max_tokens, 50, 32768, 64)
    if not extra:
        with pytest.raises(TypeError):
            jax_main.run_from_args(jax_main.add_args(
                argparse.ArgumentParser()).parse_args(argv))


def test_the_benchmark_phases_on_the_cpu(tmp_path):
    """chip_smoke's (r), (r dyn), (r rep), (r cap) and (r yaml)
    (``microbenchmarks/benchmark_phase``) at the tiny model's size: the
    static trace completes with the trace's totals and equal tokens on
    the three backends, Poisson arrivals into a 64-token-block arena
    complete, two replicas complete their shares, the capacity search
    probes, and a YAML file runs through ``run_from_flat``."""
    from vattention_tpu_torch.benchmark.capacity_search import CapacitySearch
    from vattention_tpu_torch.benchmark.capacity_search.capacity_search \
        import SLOConfig
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase

    trace = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "processed_traces",
        "arxiv_synthetic_v2.csv")
    base = dict(model="tiny-llama-debug", dtype="float32", seed=0,
                scheduler_type="sarathi", max_batch_size=4, max_num_seqs=4,
                max_model_len=1024, device="cpu", write_metrics=True,
                output_dir=str(tmp_path / "out"))
    static = dict(num_requests=3, prefill_tokens=300, decode_tokens=5,
                  interval_generator="static", length_generator="fixed",
                  seed=0)
    tokens = {}
    for backend in ("fa_vattn_2mb", "fa_paged_256", "fa_pod"):
        res = phase.serve(dict(base, attention_backend=backend,
                               chunk_size=256), static)
        phase.check_static(res, 3, 300, 5, backend)
        assert res["graphs_warm"] == res["graphs_end"] == 0
        assert sorted(res["prompts"]) == ["bench0", "bench1", "bench2"]
        tokens[backend] = res["tokens"]
        res["runner"].engine.cleanup()
    assert tokens["fa_paged_256"] == tokens["fa_vattn_2mb"]
    assert tokens["fa_pod"] == tokens["fa_vattn_2mb"]

    kw = dict(base, attention_backend="fa_vattn_64kb", chunk_size=128)
    kw["gpu_memory_utilization"] = phase.utilization_for_kv(kw, 64 * 2**20)
    res = phase.serve(kw, dict(num_requests=6, interval_generator="poisson",
                               qps=40.0, length_generator="trace",
                               trace_file=trace, prefill_scale_factor=0.05,
                               max_tokens=1024, seed=0),
                      check_relocations=True)
    assert res["summary"]["totals"]["completed_requests"] == 6
    assert len(res["relocations"]) == res["plans"]
    assert all(ok for _, ok in res["relocations"])
    assert res["runner"].engine.worker.cache_engine.block_tokens == 64
    res["runner"].engine.cleanup()

    rep = phase.replicas(dict(base, attention_backend="fa_vattn_2mb",
                              chunk_size=256), static, 2)
    assert [p["completed_requests"]
            for p in rep["summary"]["per_replica_totals"]] == [2, 1]

    search = CapacitySearch(
        dict(base, attention_backend="fa_vattn_2mb", chunk_size=256),
        dict(length_generator="trace", trace_file=trace,
             prefill_scale_factor=0.02, max_tokens=1024, seed=0),
        SLOConfig(), num_requests=3)
    search.search(qps_low=50.0, qps_high=100.0, max_iters=1)
    assert [p["qps"] for p in search.probes][:2] == [50.0, 100.0]

    summary = phase.from_yaml(
        {"output_dir": str(tmp_path / "yaml"),
         "model": {"name": "tiny-llama-debug", "dtype": "float32",
                   "load_format": "dummy", "max_model_len": 1024,
                   "max_batch_size": 4},
         "replica_scheduler": {"max_batch_size": 4},
         "synthetic_request_generator": {"num_requests": 2},
         "fixed_request_length_generator": {"prefill_tokens": 200,
                                            "decode_tokens": 4}},
        str(tmp_path), "cpu", log=lambda _: None)
    assert (summary["totals"]["completed_requests"],
            summary["totals"]["processed_tokens"]) == (2, 2 * 203)
