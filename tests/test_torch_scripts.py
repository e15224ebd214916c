"""The port's experiment scripts (``vattention_tpu_torch/scripts``,
``microbenchmarks/bench_decode_kernel``, ``examples/allocator_demo``)
against the JAX package's scripts, on the CPU.

- The static, dynamic and capacity twins build the JAX scripts' cells:
  each cell's flags, parsed by the port's ``benchmark.main.add_args``,
  equal the JAX script's, parsed by the JAX ``add_args``, but for
  ``--device`` (the JAX scripts run with their entry points recorded, no
  engine built).  ``--sweep`` is ``run_dynamic_sweep.sh``'s invocation.
  One capacity probe runs in both packages at the tiny model's size, with
  the same totals; the static and dynamic tiny cells are in
  ``test_torch_scripts_cells.py``.  The step profiler's ``drive`` counts
  the JAX ``drive()``'s prefill steps on the same arguments.
- The grid: ``scripts/run_longctx_grid.sh`` itself runs with a ``python``
  on ``PATH`` that records its flags (and a ``sleep`` that returns at
  once); each group's cells must be the twin's, flag for flag.  The
  ``controls`` and ``tuned`` groups are refused; a failed cell makes the
  exit code non-zero; ``--test`` runs a group end to end on the CPU,
  through the collector, the archive and the tables.
- The same cell directories and results through the JAX and the port's
  collector, ``process_e2e_*`` and ``render_perf_tables``: equal JSON and
  tables.
- The allocator demo on the native core (and the Python allocator) and
  the JAX demo: equal relocation MB per step and fragmentation per pass.
- ``bench_decode_kernel --device cpu`` at two plan points.
- Every script raises without a GPU unless given ``--device cpu``.
"""

import argparse
import json
import os
import re
import runpy
import shlex
import shutil
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vattention_tpu.benchmark import main as jax_main
from vattention_tpu.benchmark.capacity_search import (
    capacity_search as jax_capacity)
from vattention_tpu_torch.benchmark import main as port_main
from vattention_tpu_torch.examples import allocator_demo
from vattention_tpu_torch.microbenchmarks import bench_decode_kernel
from vattention_tpu_torch.scripts import (
    benchmark_e2e_dynamic_trace as port_dynamic,
    benchmark_e2e_static_trace as port_static, collect_longctx_grid,
    longctx_grid, measure_pp_step, process_e2e_dynamic, process_e2e_static,
    profile_backend_step, profile_decode_step, render_perf_tables,
    run_capacity_search)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TRACE = ROOT / "data" / "processed_traces" / "arxiv_synthetic_v2.csv"
FAKE_SUMMARY = {
    "totals": {"makespan_s": 1.0, "tokens_per_s": 1.0, "preemptions": 0},
    "request_e2e_time_normalized": {"p50": 0.1, "p90": 0.2, "p99": 0.3},
    "scheduling_delay": {"p50": 0.0, "p99": 0.0},
    "ttft": {"p50": 0.0, "p90": 0.0},
}


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


def run_jax_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.syspath_prepend(str(SCRIPTS))
    runpy.run_path(str(SCRIPTS / name), run_name="__main__")


def jax_cells(name, argv, monkeypatch):
    """The argument namespaces the JAX script hands ``run_from_args``."""
    seen = []

    def record(args):
        seen.append(vars(args))
        return FAKE_SUMMARY

    monkeypatch.setattr(jax_main, "run_from_args", record)
    run_jax_script(name, argv, monkeypatch)
    return seen


def port_cells(cells):
    """Each cell's flags parsed by the port's ``add_args``, ``--device``
    checked and dropped."""
    out = []
    for _, argv in cells:
        args = vars(port_main.add_args(argparse.ArgumentParser())
                    .parse_args(argv))
        assert args.pop("device") == "cpu"
        out.append(args)
    return out


@pytest.mark.parametrize("argv", [
    [],
    ["--test"],
    ["--models", "yi-6b-200k", "mistral-7b", "--backends", "fa_vattn_2mb",
     "fa_paged_256", "fa_pod", "--contexts", "32768", "131072",
     "--pd-ratios", "500", "100", "50", "--num-requests", "8",
     "--max-batch-size", "4", "--chunk-size", "1024"],
])
def test_static_cells_are_the_jax_scripts(argv, tmp_path, monkeypatch):
    out = ["--output", str(tmp_path / "e2e_static.json")]
    expect = jax_cells("benchmark_e2e_static_trace.py", argv + out,
                       monkeypatch)
    args = port_static.parser().parse_args(argv + out + ["--device", "cpu"])
    cells = port_static.cells(args)
    assert port_cells(cells) == expect
    assert len(cells) == (1 if "--test" in argv else
                          len(args.models) * len(args.backends)
                          * len(args.contexts) * len(args.pd_ratios))
    for keys, _ in cells:
        decode = max(1, keys["ctx"] // (keys["pd_ratio"] + 1))
        assert (keys["model"], keys["backend"]) in {
            (m, b) for m in args.models for b in args.backends}
        assert decode >= 1


def _sweep_flags():
    """The flags ``scripts/run_dynamic_sweep.sh`` passes."""
    text = (SCRIPTS / "run_dynamic_sweep.sh").read_text().replace("\\\n", " ")
    line = next(l for l in text.splitlines()
                if "benchmark_e2e_dynamic_trace.py" in l)
    flags = shlex.split(line)[2:]
    i = flags.index("--output")
    return flags[:i] + flags[i + 2:]


@pytest.mark.parametrize("argv", [
    [],
    ["--test"],
    ["--trace-file", str(TRACE), "--qps", "2", "--num-requests", "48",
     "--time-limit", "60"],
    "sweep",
])
def test_dynamic_cells_are_the_jax_scripts(argv, tmp_path, monkeypatch):
    out = ["--output", str(tmp_path / "e2e_dynamic.json")]
    port_argv = ["--sweep"] if argv == "sweep" else argv
    jax_argv = _sweep_flags() if argv == "sweep" else argv
    expect = jax_cells("benchmark_e2e_dynamic_trace.py", jax_argv + out,
                       monkeypatch)
    args = port_dynamic.parse(port_argv + out + ["--device", "cpu"])
    assert port_cells(port_dynamic.cells(args)) == expect
    if argv == "sweep":
        assert len(expect) == 9


def test_capacity_search_is_the_jax_scripts(tmp_path, monkeypatch):
    """The JAX script's engine kwargs, workload, SLO and search bounds,
    recorded, against the port's: equal but for the device and the probe
    output directory (the port writes under benchmark_output/)."""
    seen = []

    class Recorder:
        def __init__(self, engine_kwargs, generator_config, slo, *,
                     num_requests, time_limit_s):
            seen.append(dict(engine_kwargs=engine_kwargs,
                             generator_config=generator_config,
                             slo=vars(slo), num_requests=num_requests,
                             time_limit_s=time_limit_s))
            self.probes = []

        def search(self, **kw):
            seen[-1]["search"] = kw
            return 1.0

    monkeypatch.setattr(jax_capacity, "CapacitySearch", Recorder)
    argv = ["--backends", "fa_vattn_2mb", "fa_pod", "--slo-s", "2",
            "--num-requests", "32"]
    run_jax_script("run_capacity_search.py",
                   argv + ["--output", str(tmp_path / "c.json")],
                   monkeypatch)
    args = run_capacity_search.parser().parse_args(argv + ["--device", "cpu"])
    assert [r["engine_kwargs"]["attention_backend"] for r in seen] == [
        "fa_vattn_2mb", "fa_pod"]
    for backend, ref in zip(args.backends, seen):
        search = run_capacity_search.make_search(args, backend)
        kw = dict(search.engine_kwargs)
        assert kw.pop("device") == "cpu"
        assert kw.pop("output_dir") == run_capacity_search.PROBE_DIR
        ref_kw = dict(ref["engine_kwargs"])
        ref_kw.pop("output_dir")
        assert kw == ref_kw
        assert search.generator_config == ref["generator_config"]
        assert vars(search.slo) == ref["slo"]
        assert (search.num_requests, search.time_limit_s) == (
            ref["num_requests"], ref["time_limit_s"])
        assert run_capacity_search.SEARCH == ref["search"]


def test_a_capacity_probe_runs_in_both_packages(tmp_path, monkeypatch):
    """One probe of each package's search as ``run_capacity_search``
    builds it, cut to the tiny model, batch 4, chunk 128 and 4 requests of
    64 + 4 tokens.  Whether the SLO holds is not compared: the JAX
    engine's compiles on the CPU take seconds of scheduling delay."""
    from vattention_tpu.metrics.metrics_store import MetricsStore as J
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore as T

    monkeypatch.chdir(tmp_path)
    args = run_capacity_search.parser().parse_args([
        "--model", "tiny-llama-debug", "--num-requests", "4",
        "--prefill-tokens", "64", "--decode-tokens", "4",
        "--max-model-len", "256", "--device", "cpu"])
    port = run_capacity_search.make_search(args, "fa_vattn")
    port.engine_kwargs.update(max_batch_size=4, max_num_seqs=4,
                              chunk_size=128)
    engine_kwargs = dict(port.engine_kwargs, output_dir=str(tmp_path / "j"))
    engine_kwargs.pop("device")
    ref = jax_capacity.CapacitySearch(
        engine_kwargs, port.generator_config,
        jax_capacity.SLOConfig(**vars(port.slo)),
        num_requests=port.num_requests, time_limit_s=port.time_limit_s)
    ref._probe(50.0)
    expect = J._instance.summary()["totals"]
    port._probe(50.0)
    got = T._instance.summary()["totals"]
    assert {k: got[k] for k in TOTALS} == {k: expect[k] for k in TOTALS}
    assert got["completed_requests"] == 4
    assert [p["qps"] for p in port.probes] == [
        p["qps"] for p in ref.probes] == [50.0]


def test_drive_counts_the_jax_prefill_steps():
    """2 prompts of 1100 tokens at chunk 2048: two prefill steps in both
    packages' ``drive``, the async engine's lag included."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        import profile_backend_step as jax_profile
    finally:
        sys.path.remove(str(SCRIPTS))
    expect = jax_profile.drive("tiny-llama-debug", "fa_paged_256", 1100, 2,
                               1, "none")
    got = profile_backend_step.drive("tiny-llama-debug", "fa_paged_256",
                                     1100, 2, 1, "none", "cpu")
    assert got[1] == expect[1] == 2
    assert got[0] > 0 and got[2] > 0


# ------------------------------------------------------------------ #
# the grid against run_longctx_grid.sh
# ------------------------------------------------------------------ #
FAKE_PYTHON = """#!/bin/bash
printf '%s\\x1f' "$@" >> "$RECORD"
echo >> "$RECORD"
while [ $# -gt 0 ]; do
  if [ "$1" = "--output-dir" ]; then
    mkdir -p "$2"
    echo '{"totals": {"makespan_s": 1, "tokens_per_s": 1, "preemptions": 0}}' > "$2/summary.json"
  fi
  shift
done
"""


@pytest.fixture(scope="module")
def shell_grid(tmp_path_factory):
    """``run(tier)`` runs run_longctx_grid.sh with TIER=tier in a scratch
    tree whose ``python`` records each cell's flags, and returns them."""
    root = tmp_path_factory.mktemp("grid")
    (root / "scripts").mkdir()
    shutil.copy(SCRIPTS / "run_longctx_grid.sh", root / "scripts")
    bin_dir = root / "bin"
    bin_dir.mkdir()
    for name, body in (("python", FAKE_PYTHON),
                       ("sleep", "#!/bin/bash\nexit 0\n")):
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(stat.S_IRWXU)
    import subprocess

    def run(tier):
        record = root / f"record_{tier}"
        shutil.rmtree(root / "benchmark_output", ignore_errors=True)
        env = dict(os.environ, TIER=tier, RECORD=str(record),
                   PATH=f"{bin_dir}:{os.environ['PATH']}")
        proc = subprocess.run(["bash", str(root / "scripts" /
                                           "run_longctx_grid.sh")],
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "grid done" in proc.stdout
        cells = []
        for line in record.read_text().splitlines():
            argv = line.split("\x1f")[:-1]
            assert argv[:2] == ["-m", "vattention_tpu.benchmark.main"]
            cells.append(argv[2:])
        return cells

    return run


@pytest.mark.parametrize("group", longctx_grid.GROUPS)
def test_grid_groups_are_the_shell_scripts(group, shell_grid):
    expect = shell_grid(group)
    twin = longctx_grid.group_cells(group)
    got = [c.argv("benchmark_output/longctx") for c in twin]
    if group == "pod":
        # the shell runs each pod cell twice, the first run discarded
        got = [a for a in got for _ in range(2)]
    assert got == expect
    for c in twin:
        flags = dict(zip(c.argv("o")[::2], c.argv("o")[1::2]))
        assert flags["--output-dir"] == os.path.join("o", c.tag)
        assert int(flags["--prefill-tokens"]) + int(
            flags["--decode-tokens"]) == c.ctx
        assert int(flags["--max-model-len"]) == c.ctx + 128
        assert flags["--max-batch-size"] == str(c.batch)
        assert flags["--num-requests"] == str(c.nreq)
        assert re.fullmatch(rf"{c.backend}.*_c{c.ctx}_pd{c.pd}", c.tag)


def test_grid_aliases_are_the_shell_scripts_less_the_dropped_groups(
        shell_grid):
    """``headline`` is the shell's; ``full`` and ``extras`` are the shell's
    without the controls and tuned cells, each pod cell once."""
    assert [c.argv("benchmark_output/longctx")
            for c in longctx_grid.cells("headline")] == shell_grid("headline")
    for tier in ("full", "extras"):
        expect = []
        for argv in shell_grid(tier):
            tag = os.path.basename(argv[argv.index("--output-dir") + 1])
            if re.search(r"_(w512|w256|tuned)_", tag) or (
                    expect and expect[-1] == argv):
                continue
            expect.append(argv)
        assert [c.argv("benchmark_output/longctx")
                for c in longctx_grid.cells(tier)] == expect


@pytest.mark.parametrize("tier", ["controls", "tuned", "pairs,controls"])
def test_grid_refuses_the_tpu_tiling_groups(tier, tmp_path):
    with pytest.raises(ValueError, match="TPU tiling knobs"):
        longctx_grid.main(["--tier", tier, "--out", str(tmp_path),
                           "--device", "cpu"])
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError, match="unknown grid group"):
        longctx_grid.parse_tier("pairs,wide")


def test_a_failed_cell_fails_the_grid(tmp_path, monkeypatch, capsys):
    """Every cell runs; the failed one is named and the exit code is 1."""
    import subprocess

    ran = []

    def fake_run(cmd, stdout, **kw):
        tag = os.path.basename(cmd[cmd.index("--output-dir") + 1])
        ran.append(tag)
        stdout.write(f"{tag} ran\n")
        return subprocess.CompletedProcess(cmd, 1 if len(ran) == 2 else 0)

    monkeypatch.setattr(longctx_grid.subprocess, "run", fake_run)
    rc = longctx_grid.main(["--tier", "pairs", "--out", str(tmp_path),
                            "--device", "cpu"])
    assert rc == 1
    assert ran == [c.tag for c in longctx_grid.group_cells("pairs")]
    out = capsys.readouterr().out
    assert f"1 of 6 cells failed: {ran[1]} (exit 1)" in out


def test_grid_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``--test`` shrinks each cell to the tiny model: the pod group runs
    as processes, then the collector, its archive and the tables."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    assert longctx_grid.main(["--tier", "pod", "--test", "--device",
                              "cpu"]) == 0
    out = collect_longctx_grid.main(["--device", "cpu", "--archive"])
    tags = [c.tag for c in longctx_grid.group_cells("pod")]
    assert [r["tag"] for r in out["configs"]] == tags
    assert all(r["preemptions"] == 0 and "stall_s" in r
               for r in out["configs"])
    archive = tmp_path / collect_longctx_grid.ARCHIVE
    assert sorted(p.name for p in (archive / "longctx").iterdir()) == sorted(
        tags + [t + ".log" for t in tags])
    assert json.loads((archive / "grid_results.json").read_text()) == out
    lines = render_perf_tables.main(["--device", "cpu"])
    assert lines[2].startswith("| 32K | 100 |")


def test_cell_configs_are_the_cells_flags():
    """chip_smoke (l) builds each cell in its own process from the flags
    a grid subprocess gets: the 128K pair's engine and trace."""
    cell = longctx_grid.group_cells("pairs")[4]
    engine_kwargs, gen = longctx_grid.cell_configs(cell, "out", "cpu")
    assert (cell.tag, engine_kwargs["output_dir"]) == (
        "fa_vattn_2mb_c131072_pd100", os.path.join("out", cell.tag))
    assert {k: engine_kwargs[k] for k in (
        "model", "load_format", "chunk_size", "max_model_len",
        "max_batch_size", "gpu_memory_utilization", "device")} == dict(
        model="yi-6b-200k-l16", load_format="zero", chunk_size=2048,
        max_model_len=131200, max_batch_size=2, gpu_memory_utilization=0.93,
        device="cpu")
    assert {k: gen[k] for k in ("num_requests", "prefill_tokens",
                                "decode_tokens", "interval_generator")} == \
        dict(num_requests=4, prefill_tokens=129775, decode_tokens=1297,
             interval_generator="static")


def test_the_archive_refuses_data(tmp_path):
    (tmp_path / "g.json").write_text("{}")
    with pytest.raises(ValueError, match="data/"):
        collect_longctx_grid.archive(str(tmp_path), str(tmp_path / "g.json"),
                                     str(ROOT / "data" / "results_port"))


# ------------------------------------------------------------------ #
# the collector and the tables against the JAX scripts
# ------------------------------------------------------------------ #
CELL_TAGS = [
    "fa_vattn_2mb_c32768_pd100", "fa_paged_256_c32768_pd100",
    "fa_vattn_256kb_c32768_pd100", "fa_paged_16_c32768_pd100",
    "fa_vattn_2mb_c32768_pd500", "fa_paged_256_c32768_pd500",
    "fa_vattn_2mb_fp8_c65536_pd100", "fa_paged_256_fp8_c65536_pd100",
    "fa_vattn_2mb_int8_c65536_pd100", "fa_paged_256_int8_c65536_pd100",
    "fa_vattn_2mb_mmistral_c32768_pd100",
    "fa_paged_256_mmistral_c32768_pd100", "fa_pod_c65536_pd100",
    "fa_vattn_2mb_c131072_pd100", "fa_paged_256_c131072_pd100",
    "fa_paged_256_w512_c131072_pd100", "fa_vattn_2mb_w256_c131072_pd100",
    "fa_vattn_2mb_tuned_c131072_pd100", "fa_paged_256_tuned_c131072_pd100",
]


@pytest.fixture
def grid_dir(tmp_path):
    """Seeded cell directories: a summary per tag, most with a step CSV
    holding a few stalls; a warm-up directory and a cell without a
    summary are skipped by both collectors."""
    rng = np.random.default_rng(5)
    d = tmp_path / "longctx"
    for i, tag in enumerate(CELL_TAGS):
        (d / tag).mkdir(parents=True)
        (d / tag / "summary.json").write_text(json.dumps({"totals": {
            "makespan_s": float(rng.uniform(5, 50)),
            "tokens_per_s": float(rng.uniform(1e4, 4e4)),
            "preemptions": int(rng.integers(0, 3))}}))
        if i % 4 != 3:
            steps = rng.uniform(0.01, 0.03, 200)
            steps[rng.integers(0, 200, 3)] = rng.uniform(0.6, 3.0, 3)
            (d / tag / "batch_execution_time.csv").write_text(
                "idx,batch_execution_time\n"
                + "".join(f"{j},{t}\n" for j, t in enumerate(steps)))
    (d / "warm_pod_c32768").mkdir()
    (d / "warm_pod_c32768" / "summary.json").write_text("{}")
    (d / "fa_vattn_2mb_c8192_pd100").mkdir()
    return d


def test_collector_is_the_jax_collector(grid_dir, tmp_path, monkeypatch,
                                        capsys):
    ref, got = tmp_path / "jax.json", tmp_path / "port.json"
    run_jax_script("collect_longctx_grid.py",
                   ["--dir", str(grid_dir), "--output", str(ref)],
                   monkeypatch)
    expect_out = capsys.readouterr().out
    collect_longctx_grid.main(["--dir", str(grid_dir), "--output", str(got),
                               "--device", "cpu"])
    assert capsys.readouterr().out.replace(str(got), str(ref)) == expect_out
    expect = json.loads(ref.read_text())
    assert json.loads(got.read_text()) == expect
    assert len(expect["configs"]) == len(CELL_TAGS)
    assert sum("stall_s" in r for r in expect["configs"]) > 10
    assert expect["vs_paged"] and expect["decomposition"] == []


@pytest.mark.parametrize("script,module,kind", [
    ("process_e2e_static.py", process_e2e_static, "grid"),
    ("process_e2e_static.py", process_e2e_static, "flat"),
    ("process_e2e_dynamic.py", process_e2e_dynamic, "dynamic"),
    ("render_perf_tables.py", render_perf_tables, "grid"),
])
def test_tables_are_the_jax_scripts(script, module, kind, grid_dir,
                                    tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(7)
    path = tmp_path / f"{kind}.json"
    if kind == "grid":
        path.write_text(json.dumps(collect_longctx_grid.collect(
            str(grid_dir))))
    elif kind == "flat":
        path.write_text(json.dumps([
            dict(model=m, backend=b, ctx=c, pd_ratio=100,
                 makespan_s=float(rng.uniform(1, 9)), tokens_per_s=1.0,
                 preemptions=0)
            for m in ("yi-6b-200k", "mistral-7b") for c in (32768, 65536)
            for b in ("fa_vattn_2mb", "fa_paged_256", "fa_pod")]))
    else:
        path.write_text(json.dumps({"meta": {"qps": [0.8, 2.0]}, "results": [
            dict(model="m", backend=b, qps=q,
                 **{k: float(rng.uniform(0, 1)) for k in (
                     "normalized_e2e_p50", "normalized_e2e_p90",
                     "normalized_e2e_p99", "scheduling_delay_p50",
                     "scheduling_delay_p99", "ttft_p50", "ttft_p90")},
                 tokens_per_s=float(rng.uniform(1e3, 1e4)))
            for b in ("fa_vattn_2mb", "fa_paged_256") for q in (2.0, 0.8)]}))
    run_jax_script(script, [str(path)], monkeypatch)
    expect = capsys.readouterr().out
    module.main([str(path), "--device", "cpu"])
    assert capsys.readouterr().out == expect
    assert len(expect.splitlines()) > 3


@pytest.mark.parametrize("module,data", [
    (process_e2e_static, [dict(model="m", backend="fa_vattn_2mb", ctx=1024,
                               pd_ratio=100, makespan_s=1.0)]),
    (process_e2e_dynamic, [dict(backend="fa_pod", qps=1.0, **{
        k: 0.1 for k in ("normalized_e2e_p50", "normalized_e2e_p90",
                         "normalized_e2e_p99", "scheduling_delay_p99",
                         "tokens_per_s")})]),
])
def test_plot_draws_or_raises_without_matplotlib(module, data, tmp_path,
                                                 monkeypatch):
    path = tmp_path / "r.json"
    path.write_text(json.dumps(data))
    png = tmp_path / "f.png"
    module.main([str(path), "--plot", str(png), "--device", "cpu"])
    assert png.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        module.main([str(path), "--plot", str(png), "--device", "cpu"])


# ------------------------------------------------------------------ #
# the allocator demo, the decode sweep, the devices
# ------------------------------------------------------------------ #
PASS = re.compile(r"pass (\d+): .*reloc copies: (\d+) \(([\d.]+) MB/step\), "
                  r"active: (\d+), free kvblocks: (\d+), "
                  r"fragmentation: ([\d.]+)%")


@pytest.mark.parametrize("argv,allocator", [
    ([], "native"),
    (["--sync"], "native"),
    (["--page-size-kb", "2048", "--megacache", "--memory-mb", "512"],
     "native"),
    ([], "python"),
])
def test_allocator_demo_is_the_jax_demo(argv, allocator, monkeypatch,
                                        capsys):
    argv = argv + ["--steps", "1000"]
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, "argv", ["allocator_demo.py", *argv])
    runpy.run_path(str(ROOT / "examples" / "allocator_demo.py"),
                   run_name="__main__")
    expect = PASS.findall(capsys.readouterr().out)
    allocator_demo.main(argv + ["--allocator", allocator,
                                "--device", "cpu"])
    got = PASS.findall(capsys.readouterr().out)
    assert len(expect) == 2 and got == expect


def test_bench_decode_kernel_on_the_cpu(capsys):
    """Two plan points through C's plain version (the CPU takes it), each
    checked before it is timed; the plan's defaults are today's."""
    from vattention_tpu_torch.ops import flash_decode

    rows = bench_decode_kernel.sweep(bench_decode_kernel.parser().parse_args(
        ["--device", "cpu", "--plans", "4:2", "1:3", "--batch", "3",
         "--ctx", "700"]))
    assert [(r["min_split_tiles"], r["blocks_per_sm"]) for r in rows] == [
        (4, 2), (1, 3)]
    assert all(r["max_abs_err"] == 0 and r["grid"] is None and r["ms"] > 0
               for r in rows)
    assert (flash_decode.MIN_SPLIT_TILES, flash_decode.BLOCKS_PER_SM) == (
        4, 2)
    assert bench_decode_kernel.DEFAULT_PLANS[0] == "4:2"
    assert "plain version on the CPU" in capsys.readouterr().err
    with pytest.raises(ValueError, match="min_split_tiles"):
        flash_decode.decode_attention(
            torch.zeros(1, 8, 128), torch.zeros(1, 2, 1, 64, 128),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 0, sub=64, sm_scale=1.0,
            min_split_tiles=0)


@pytest.mark.parametrize("main,argv", [
    (port_static.main, []), (port_dynamic.main, []),
    (longctx_grid.main, ["--tier", "pairs"]),
    (collect_longctx_grid.main, []), (process_e2e_static.main, []),
    (process_e2e_dynamic.main, []), (render_perf_tables.main, []),
    (run_capacity_search.main, []), (profile_backend_step.main, []),
    (profile_decode_step.main, []), (measure_pp_step.main, []),
    (allocator_demo.main, []), (bench_decode_kernel.main, []),
])
def test_scripts_raise_without_a_gpu(main, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not any(tmp_path.iterdir())
