"""The static and dynamic scripts' tiny cell in both packages, on the CPU.

The ``--test`` cell (the tiny float32 model, ``load_format="zero"``)
through the port's script and the JAX script with the same flags: each
pair must complete the same requests with the same processed and decode
token totals and preemptions, and write rows with the same keys.  The
capacity probe and the step profiler's ``drive`` run in both packages in
``test_torch_scripts.py``.  Both packages' ``MetricsStore`` singletons are
reset around every test.
"""

import json
import runpy
import sys
from pathlib import Path

import pytest
import torch

from vattention_tpu_torch.scripts import (
    benchmark_e2e_dynamic_trace as port_dynamic,
    benchmark_e2e_static_trace as port_static)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TOTALS = ("completed_requests", "processed_tokens", "decode_tokens",
          "preemptions")


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


def totals_of_runs(module, monkeypatch):
    """Run-from-args of ``module`` wrapped: each run's totals."""
    runs = []
    real = module.run_from_args

    def wrapped(args):
        summary = real(args)
        runs.append({k: summary["totals"][k] for k in TOTALS})
        return summary

    monkeypatch.setattr(module, "run_from_args", wrapped)
    return runs


@pytest.mark.parametrize("script,port,argv", [
    ("benchmark_e2e_static_trace.py", port_static, ["--test"]),
    # lengths fixed and arrivals fast: the JAX engine compiles one
    # prompt length and the runner waits no wall time for arrivals
    ("benchmark_e2e_dynamic_trace.py", port_dynamic,
     ["--test", "--qps", "100", "--min-tokens", "200", "--max-tokens",
      "200"]),
])
def test_the_tiny_cell_runs_in_both_packages(script, port, argv, tmp_path,
                                             monkeypatch):
    from vattention_tpu.benchmark import main as jax_main
    from vattention_tpu_torch.benchmark import main as port_main

    monkeypatch.chdir(tmp_path)
    jax_runs = totals_of_runs(jax_main, monkeypatch)
    port_runs = totals_of_runs(port_main, monkeypatch)
    monkeypatch.setattr(sys, "argv", [script, *argv, "--output",
                                      str(tmp_path / "jax.json")])
    monkeypatch.syspath_prepend(str(SCRIPTS))
    runpy.run_path(str(SCRIPTS / script), run_name="__main__")
    port.main(argv + ["--output", str(tmp_path / "port.json"),
                      "--device", "cpu"])
    assert len(jax_runs) == len(port_runs) == 1
    assert port_runs == jax_runs
    assert port_runs[0]["completed_requests"] == 2
    rows = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    if isinstance(ref, dict):
        assert rows["meta"]["qps"] == ref["meta"]["qps"]
        rows, ref = rows["results"], ref["results"]
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
