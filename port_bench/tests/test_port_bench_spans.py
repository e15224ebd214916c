"""The per-layer metrics read from the program's own spans, on the CPU.

A bench file under ``tmp_path`` declares them for the test-only cell
``tiny.open``, as a later change declares its metrics by adding entries;
a traced run reads each from the spans the program recorded while the
profiler ran.  The program's span names keep clear of the harness's own
spans and of the kernel families.
"""

import json
import shutil
import time

import pytest
import torch

from port_bench import run, trace
from port_bench.cells import ROOT

SEED = 2**31 + 11
SECONDS = 2.0
SPAN_METRICS = {
    "engine.host_busy_ms": "ms", "engine.outputs_ms": "ms",
    "runner.prepare_ms": "ms", "sched.schedule_ms": "ms",
    "sched.prefill_p90_s": "s", "runner.captures": "captures",
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_span_metrics_read_a_traced_run(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "traffic", "workloads"):
        for f in (ROOT / "tests" / kind).iterdir():
            shutil.copy(f, root / kind / f.name)
    bench = json.loads((root / "tests" / "bench.json").read_text())
    for name, unit in SPAN_METRICS.items():
        bench["per_layer"].append({"name": name, "unit": unit,
                                   "workloads": ["tiny.open"]})
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))

    result, info = run.execute("tiny.open", SEED, SECONDS, True,
                               device="cpu", root=root, bench=path,
                               t_start=time.monotonic())
    assert result["correct"], result["compared"]
    metrics = {k: m["value"] for k, m in result["metrics"].items()}
    for name in SPAN_METRICS:
        assert name in metrics, (name, metrics)
        if name != "runner.captures":
            assert metrics[name] > 0, (name, metrics)
    # the CPU runs every step eagerly: nothing is captured
    assert metrics["runner.captures"] == 0
    assert metrics["engine.host_busy_ms"] <= metrics[
        "engine.host_ms_per_step"]
    assert info["steps"] > 0
    assert not [op for op, _ in result["breakdown"]["device_ops"]
                if "vattn." in op]


def test_span_names_keep_clear_of_the_harness():
    """No program span is named as a harness span (``engine.step`` counts
    the steps) or holds a kernel family's name (the device's time by
    family)."""
    from vattention_tpu_torch.metrics import timer

    families = (trace.PREFILL_ATTN + trace.DECODE_ATTN + trace.PORT
                + trace.MATMUL + trace.SYNCS)
    for name in timer.NAMES:
        assert name not in trace.SPANS
        assert not any(f.lower() in name.lower() for f in families), name
        assert trace.family(name) == "other"
