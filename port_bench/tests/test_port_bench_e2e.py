"""The whole harness on the CPU at the tiny models' size.

Each run skips the harness's look for a card (``run.execute`` with
``device="cpu"``) and drives the rest: the port's engine on the CPU (its
kernels' plain versions), the clients, the window, the reference and the
verdict.  The cells are test-only (``tests/configs``, ``tests/traffic``,
``tests/workloads``, ``tests/bench.json``), dropped into a copy of
``port_bench/`` as a later change would add its own.
"""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench import run
from port_bench.cells import ROOT

SEED = 2**31 + 5          # more than 32 signed bits hold
SECONDS = 2.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of port_bench/ with the test-only cells added as files."""
    dst = tmp_path_factory.mktemp("bench") / "port_bench"
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "traffic", "workloads"):
        for f in (ROOT / "tests" / kind).iterdir():
            shutil.copy(f, dst / kind / f.name)
    return dst


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def execute(root, cell, trace=False, **kw):
    return run.execute(cell, kw.pop("seed", SEED), SECONDS, trace,
                       device="cpu", root=root,
                       bench=root / "tests" / "bench.json",
                       t_start=time.monotonic(), **kw)


def declared(root, cell, kind):
    spec = json.loads((root / "tests" / "bench.json").read_text())
    return {m["name"] for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.resid", "tiny.open"])
def test_a_cell_runs_and_is_correct(root, cell):
    result, info = execute(root, cell)
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == declared(root, cell, "end_to_end")
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["compared"]["requests"] >= 1
    assert info["tokens"] > 0 and info["steps"] > 0
    for m in result["metrics"].values():
        assert m["value"] > 0


def test_a_traced_run_reports_the_per_layer_metrics(root):
    result, _ = execute(root, "tiny.open", trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == declared(root, "tiny.open",
                                              "per_layer")
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_reference_equals_the_program_in_float32(root):
    """At float32 the port's logprobs and the reference's agree to
    rounding, and every greedy token is the reference's first choice:
    the reference's RoPE, GQA grouping, window and norms are the
    program's equations."""
    workload = root / "workloads" / "tiny.f32.json"
    w = json.loads((root / "workloads" / "tiny.resid.json").read_text())
    w["engine"]["dtype"] = "float32"
    workload.write_text(json.dumps(w))
    bench = json.loads((root / "tests" / "bench.json").read_text())
    bench["workloads"].append({"name": "tiny.f32", "config": "tiny-mistral",
                               "traffic": "tiny-resid", "chips": 1,
                               "why": "test"})
    path = root / "tests" / "bench-f32.json"
    path.write_text(json.dumps(bench))
    result, _ = run.execute("tiny.f32", SEED, SECONDS, False, device="cpu",
                            root=root, bench=path,
                            t_start=time.monotonic())
    assert result["compared"]["gap"]["value"] < 1e-3
    assert result["compared"]["lp_err"]["value"] < 1e-3
    assert result["compared"]["tokens"] > 100


@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.resid"])
def test_the_control_is_not_correct(root, cell):
    """The program with its e4m3 K/V switched on, the precision below the
    configuration's bf16, fails the cell's limits."""
    result, _ = execute(root, cell, kv_quant="fp8")
    assert not result["correct"]
    c = result["compared"]
    assert (c["gap"]["value"] > c["gap"]["limit"]
            or c["lp_err"]["value"] > c["lp_err"]["limit"])


def _kv_unwritten(monkeypatch):
    """A step that leaves its state unchanged: K/V never reach the
    arena."""
    from vattention_tpu_torch.model_executor.attention import vattn_backend

    cls = vattn_backend.VattnAttentionBackend
    original = cls.rope_append_kv

    def rope_only(self, kv_cache, qkv, rope, inputs, layer, **kw):
        return original(self, kv_cache.clone(), qkv, rope, inputs, layer,
                        **kw)

    monkeypatch.setattr(cls, "rope_append_kv", rope_only)


def _zero_decode_slots(monkeypatch, rows):
    """Every step's decode attention zero in the slots ``rows(B)`` of its
    B decode rows, the same slots in every step."""
    from vattention_tpu_torch.model_executor.attention import vattn_backend

    cls = vattn_backend.VattnAttentionBackend
    original = cls.attend

    def half(self, q, kv_cache, inputs, layer, n_prefill_tokens, **kw):
        out = original(self, q, kv_cache, inputs, layer, n_prefill_tokens,
                       **kw).clone()
        dec = out[n_prefill_tokens:]
        dec[rows(dec.shape[0])] = 0
        return out

    monkeypatch.setattr(cls, "attend", half)


def _half_batch(monkeypatch):
    """Half of the batch left out: the odd decode slots' attention is
    zero in every step."""
    _zero_decode_slots(monkeypatch, lambda B: slice(1, None, 2))


def _upper_half_batch(monkeypatch):
    """Half of the batch left out: the upper half of the decode slots'
    attention is zero in every step."""
    _zero_decode_slots(monkeypatch, lambda B: slice(B // 2, None))


def _token_altered(monkeypatch):
    """A token altered where it is produced: the sampler's choice moved to
    the next id for every slot."""
    from vattention_tpu_torch.model_executor import model_runner

    original = model_runner.sample_tokens

    def shifted(logits, *args, **kw):
        return (original(logits, *args, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(model_runner, "sample_tokens", shifted)


@pytest.mark.parametrize("fault", [_kv_unwritten, _half_batch,
                                   _upper_half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = execute(root, "tiny.resid")
    assert not result["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.closed", _half_batch), ("tiny.closed", _upper_half_batch),
    ("tiny.open", _half_batch)])
@pytest.mark.parametrize("seed", [SEED, 7])
def test_half_the_batch_left_out_meets_the_sample(root, monkeypatch, cell,
                                                  fault, seed):
    """Whichever fixed half of the slots in use is left out, the sample
    holds a request that sat in it, on every seed: in the closed loop,
    where the longest request sits in one slot for its life, and in the
    open loop.  (The open loop's upper half of slots holds no request.)"""
    fault(monkeypatch)
    result, _ = execute(root, cell, seed=seed)
    assert not result["correct"], result["compared"]


def test_the_sample_covers_each_half_of_the_slots():
    """Besides the longest request, one request from each half of the
    slots (even and odd, lower and upper) that the chosen ones leave
    uncovered, the cheap ones first; a class no request sat in is not
    live and needs none."""
    from types import SimpleNamespace as NS

    def rec(rid, slot, prompt, n):
        return NS(req=NS(rid=rid, prompt_len=prompt), slot=slot,
                  tokens=[1] * n)

    records = [rec(0, 0, 60000, 600)] + [
        rec(1 + i, s, 20000 + 1000 * i, 200) for i, s in
        enumerate([1, 2, 3, 4, 5, 6, 7, 1, 6])] + [rec(20, 5, 50000, 500)]
    cfg = {"longest": 1, "random": 0, "cover": True,
           "cover_positions": 30000}
    for seed in range(5):
        chosen = run.sample(records, seed, cfg, 8)
        assert chosen[0].req.rid == 0
        slots = {r.slot for r in chosen}
        for parity in (0, 1):
            for upper in (False, True):
                assert any(s % 2 == parity and (s >= 4) == upper
                           for s in slots)
        assert len(chosen) == 4
        assert all(r.req.prompt_len + len(r.tokens) <= 30000
                   for r in chosen[1:])
    assert run.slot_classes({0, 1}, 8) == [frozenset({0}), frozenset({1})]


def test_a_new_cell_config_mix_and_metric_are_files(root, tmp_path):
    """A later change adds a configuration, a model family, a mix with a
    traffic kind and a length distribution of its own, a cell and a
    metric by adding files; the harness finds them by name."""
    new = tmp_path / "port_bench"
    shutil.copytree(root, new)
    cfg = json.loads((new / "configs" / "tiny-llama.json").read_text())
    cfg["name"] = "tiny-llama-b"
    cfg["model_type"] = "llama_b"
    (new / "configs" / "tiny-llama-b.json").write_text(json.dumps(cfg))
    (new / "families" / "llama_b.py").write_text(
        '"""A family of its own, with the Llama layout."""\n\n'
        "from port_bench.families.llama import (  # noqa: F401\n"
        "    load_into_program, shapes)\n")
    (new / "reference" / "llama_b.py").write_text(
        '"""Its plain forward."""\n\n'
        "from port_bench.reference.llama import Reference  # noqa: F401\n")
    (new / "traffic" / "kinds" / "even_open.py").write_text(
        '"""An open loop at evenly spaced arrivals."""\n\n'
        "from port_bench.generator import open_arrivals\n\n"
        "CLOSED = False\n\n\n"
        "def arrivals(t, seconds):\n"
        "    return open_arrivals(\n"
        "        t, seconds, lambda rate, n, span: [span / (n + 1)] * n)\n")
    (new / "traffic" / "dists" / "fixed.py").write_text(
        '"""Every length the same."""\n\n\n'
        "def sizes(args, n):\n"
        "    return [args] * n\n")
    (new / "traffic" / "tiny-even.json").write_text(json.dumps(
        {"kind": "even_open", "rate": 4.0, "ramp_s": 0.5,
         "prompt": {"fixed": 150}, "output": {"uniform": [8, 16]}}))
    shutil.copy(new / "workloads" / "tiny.open.json",
                new / "workloads" / "tiny.even.json")
    (new / "metrics" / "served_requests.py").write_text(
        '"""Requests with every token served in the window."""\n\n\n'
        "def read(run):\n"
        "    return float(sum(1 for r in run.records\n"
        "                     if r.finished_at is not None\n"
        "                     and r.finished_at < run.t_close))\n")
    bench = json.loads((new / "tests" / "bench.json").read_text())
    bench["workloads"].append({"name": "tiny.even", "config": "tiny-llama-b",
                               "traffic": "tiny-even", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "served_requests", "unit": "1",
                                "workloads": ["tiny.even"]})
    path = new / "tests" / "bench.json"
    path.write_text(json.dumps(bench))
    result, info = run.execute("tiny.even", SEED, SECONDS, False,
                               device="cpu", root=new, bench=path,
                               t_start=time.monotonic())
    assert result["correct"], result["compared"]
    assert result["metrics"]["served_requests"]["value"] >= 1
    assert "setup_s" in result["metrics"]
    assert info["sent"] == round(4.0 * 0.5) + round(4.0 * SECONDS)


def test_nothing_of_jax_is_loaded_by_a_run(root):
    """In a process of its own: a whole run loads no module whose
    top-level name is jax, jaxlib, flax or vattention_tpu."""
    code = (
        "import time, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from port_bench import run\n"
        f"root = Path({str(root)!r})\n"
        "r, _ = run.execute('tiny.resid', 3, 1.0, True, device='cpu',"
        " root=root, bench=root / 'tests' / 'bench.json',"
        " t_start=time.monotonic())\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    for path in ROOT.rglob("*.py"):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax",
                                          "vattention_tpu"}, path
    for path in (ROOT / "reference").rglob("*.py"):
        assert "vattention_tpu_torch" not in set(_imports(path)), path


def test_a_cuda_run_needs_a_card(monkeypatch, capsys):
    """Without a card the command prints no result and exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "yi6b.prefill-long", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(root):
    """The same harness on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result, _ = run.execute("tiny.resid", SEED, SECONDS, True, device="cuda",
                            root=root, bench=root / "tests" / "bench.json",
                            t_start=time.monotonic())
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0


def test_a_checkout_without_the_port_prints_no_result(monkeypatch, capsys):
    """With a card but without the port's package (a directory holding
    only BENCHMARK.json and port_bench/) the command fails, printing
    nothing on standard output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "vattention_tpu_torch", None)
    rc = run.main(["--workload", "yi6b.prefill-long", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
