"""Finds a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, so that a cell, a configuration, a mix
or a metric is added by adding a file:

- ``configs/<config>.json``: the model's published sizes, ``source``,
  ``reduced``, ``assumed``, the port's registry name (``port_model``) and
  the engine settings every cell of it shares (``engine``);
- ``traffic/<traffic>.json``: the mix's parameters, read by
  ``generator.Traffic``, which finds the mix's ``kind`` in
  ``traffic/kinds/<kind>.py`` and each named length distribution in
  ``traffic/dists/<name>.py``;
- ``families/<model_type>.py`` and ``reference/<model_type>.py``: a model
  family's weights (names, shapes, scales, the program's parameter
  layout) and its plain float32 forward, chosen by the configuration's
  ``model_type``;
- ``workloads/<cell>.json``: the cell's own engine settings, its ramp,
  the sample and the limits of the comparison that decides ``correct``;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.

``BENCHMARK.json`` says which metrics a cell reports: every end-to-end
metric and, with ``--trace 1``, every per-layer metric, each unless its
``workloads`` leaves the cell out.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

# port_bench/ itself: the files named in BENCHMARK.json live under it
ROOT = Path(__file__).resolve().parent

_LOADED: dict = {}   # the files loaded, by path


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    metrics: List[Metric]
    root: Path = ROOT

    @property
    def model_type(self) -> str:
        return self.config["model_type"]

    def family(self):
        """``families/<model_type>.py``: the weights and their layout in
        the program."""
        return load_module(self.root / "families" / f"{self.model_type}.py",
                           f"family {self.model_type!r}")

    def reference(self):
        """``reference/<model_type>.py``: the plain float32 forward."""
        return load_module(self.root / "reference" / f"{self.model_type}.py",
                           f"reference of {self.model_type!r}")

    @property
    def dims(self):
        """The sizes the counts use: the family's ``dims`` where it has
        one, else the Llama keys (``counts.Dims.of``)."""
        from port_bench import counts
        return getattr(self.family(), "dims", counts.Dims.of)(self.config)

    @property
    def engine_kwargs(self) -> dict:
        """The engine's settings: the configuration's, then the cell's."""
        kw = dict(self.config.get("engine", {}))
        kw.update(self.workload.get("engine", {}))
        return kw


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, what: str):
    """The Python file ``path``, loaded by its path (names such as a
    metric's carry dots, which module names cannot); ``what`` names it in
    the error when there is no such file."""
    if not path.is_file():
        raise KeyError(f"no {what}: {path} does not exist")
    name = "port_bench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.resolve()))
    if name not in _LOADED:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[name] = module
    return _LOADED[name]


def load_reader(root: Path, name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return load_module(root / "metrics" / f"{name}.py",
                       f"reader of the metric {name!r}").read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, trace: bool, *, bench: Optional[Path] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (the checkout's ``BENCHMARK.json``
    unless given), its files read from ``root``."""
    bench = bench or root.parent / "BENCHMARK.json"
    spec = _load_json(bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench} "
                       f"(known: {sorted(cells)})")
    entry = cells[name]
    config = _load_json(root / "configs" / f"{entry['config']}.json")
    traffic = _load_json(root / "traffic" / f"{entry['traffic']}.json")
    workload = _load_json(root / "workloads" / f"{name}.json")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
               for m in spec[kind] if _reports(m, name)]
    return Cell(name, int(entry["chips"]), config, traffic, workload,
                metrics, root)

