"""Import hygiene of the PyTorch port: no JAX, nothing of vattention_tpu.

The port (and chip_smoke.py, which drives it on the GPU) must run on a
host without JAX.  Checked twice: statically, over every import statement
of the port's sources, and dynamically, by importing every port module in
a fresh interpreter where ``jax`` and ``vattention_tpu`` are blocked.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vattention_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vattention_tpu")


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    for name in imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    script = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import vattention_tpu_torch\n"
        "vattention_tpu_torch.LLMEngine\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


# the serving entry points a user runs, and the modules under them
ENTRY_POINTS = ["vattention_tpu_torch.entrypoints.openai_server.api_server",
                "vattention_tpu_torch.examples.offline_inference"]
SERVING_MODULES = ["vattention_tpu_torch.engine.async_llm_engine",
                   "vattention_tpu_torch.entrypoints.openai_server.protocol",
                   "vattention_tpu_torch.memory.native",
                   "vattention_tpu_torch.model_executor.weight_utils",
                   "vattention_tpu_torch.microbenchmarks.checkpoint"]


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_runs_with_jax_blocked(module):
    """``python -m <module> --help`` with jax and vattention_tpu blocked:
    the parser comes up, and nothing forbidden was imported on the way."""
    script = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = [{module!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"for m in {SERVING_MODULES!r}:\n"
        "    __import__(m)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout


def test_serving_modules_exist():
    for m in SERVING_MODULES + ENTRY_POINTS:
        path = ROOT / (m.replace(".", "/") + ".py")
        assert path.exists(), path
