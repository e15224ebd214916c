"""The benchmark package end to end: chip_smoke's phases (r) to (r yaml).

chip_smoke runs these at yi-6b-200k-l16's widths on the card; the tests
run them with the tiny model on the CPU.  Each drives the port's
``vattention_tpu_torch.benchmark`` as a user does, through
``BenchmarkRunner``, ``BenchmarkRunnerLauncher`` or
``main.run_from_flat`` (chip_smoke's (r cap) calls ``CapacitySearch``
itself):

- ``serve``: one ``BenchmarkRunner`` run, watched from outside: the
  prompts and the finished requests' tokens (wrapping the engine's
  ``add_request`` and ``step``), the kernels' launch counts zeroed just
  after the warm-up and read just after the timed run, the CUDA graphs
  captured by then and at the end (none may be captured while timing),
  and the block moves and relocation plans (one kernel D launch each) of
  the timed run.  With ``check_relocations`` every plan is also held
  against the plain version: the arena is cloned before the plan runs,
  ``arena_relocate_plain`` applies the same moves to the clone, and the
  two must be equal byte for byte.  (r) runs bench.py's headline workload through it on
  three backends; (r dyn) Poisson arrivals of trace lengths into a small
  arena (``utilization_for_kv`` sizes it).
- ``replicas``: (r rep), the launcher with replicas on one device; each
  replica completes its share, the merged totals are the sums, and
  freeing the engines gives their device memory back.
- ``from_yaml``: (r yaml), ``run_from_flat`` on a YAML file written to a
  temporary directory.

A failed check raises.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Callable, Dict, Sequence

import torch

from vattention_tpu_torch.benchmark.benchmark_runner import (
    BenchmarkRunner, BenchmarkRunnerLauncher)
from vattention_tpu_torch.engine.arg_utils import EngineArgs
from vattention_tpu_torch.engine.base_llm_engine import resolve_device
from vattention_tpu_torch.worker.base_worker import device_memory, param_bytes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    """Drop the metrics singleton and give freed device memory back."""
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def utilization_for_kv(engine_kwargs: dict, kv_bytes: int) -> float:
    """The ``gpu_memory_utilization`` at which the engine's KV arena gets
    ``kv_bytes``: the worker takes the weights and a step's workspace out
    of ``total x utilization`` (``BaseWorker.profile_num_available_blocks``)."""
    config = EngineArgs(**engine_kwargs).create_engine_configs()
    _, total, workspace = device_memory(resolve_device(config.device))
    return (kv_bytes + param_bytes(config.model_config) + workspace) / total


def serve(engine_kwargs: dict, generator_config: dict, *,
          kernels: Sequence = (), check_relocations: bool = False) -> dict:
    """One ``BenchmarkRunner`` run with its warm-up.  Returns the runner
    (its engine still alive), the summary, ``prompts`` and ``tokens`` by
    seq_id of the timed requests, the launch ``counts`` of ``kernels`` in
    the timed run, ``graphs`` after the warm-up and at the end,
    ``moves`` and ``plans`` of the timed run, its ``wall_s`` (host clock
    to a device synchronization) and ``tok_s``, processed tokens over the
    makespan (bench.py's metric).  With ``check_relocations`` (the arena
    is cloned once per plan, inside the timed run) ``relocations`` lists
    each timed plan's moves and whether the arena equals the plain
    version's byte for byte; a plan that differs raises."""
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore
    from vattention_tpu_torch.ops.arena_copy import arena_relocate_plain

    MetricsStore._instance = None
    runner = BenchmarkRunner(engine_kwargs, "synthetic", generator_config,
                             warmup=True)
    engine = runner.engine
    device = engine.device
    ce = engine.worker.cache_engine
    graphs = engine.worker.model_runner.graphs
    res: dict = {"runner": runner, "prompts": {}, "tokens": {},
                 "plans": 0, "relocations": []}
    add_request, step, warmup = engine.add_request, engine.step, \
        runner._warmup
    apply_plan = getattr(ce, "_apply_plan", None)

    def watched_apply_plan(plan):
        res["plans"] += 1
        if not check_relocations:
            return apply_plan(plan)
        expect = ce.kv_cache.clone()
        apply_plan(plan)
        src, dst = (torch.tensor([getattr(mv, k) for mv in plan.moves],
                                 dtype=torch.int32) for k in ("src", "dst"))
        arena_relocate_plain(expect, src, dst, len(plan.moves),
                             ce.block_tokens)
        same = torch.equal(ce.kv_cache.view(torch.uint8),
                           expect.view(torch.uint8))
        res["relocations"].append((len(plan.moves), same))
        if not same:
            raise AssertionError(
                f"kernel D's arena differs from arena_relocate_plain's "
                f"after a plan of {len(plan.moves)} moves")

    def watched_add_request(**kw):
        res["prompts"][kw["seq_id"]] = kw["prompt_token_ids"]
        return add_request(**kw)

    def watched_step():
        outputs = step()
        for o in outputs:
            if o.finished:
                res["tokens"][o.seq_id] = list(o.token_ids)
        return outputs

    def watched_warmup():
        warmup()
        _sync(device)
        res["prompts"].clear()
        res["tokens"].clear()
        res["graphs_warm"] = len(graphs)
        res["moves"] = getattr(ce, "pending_moves", 0)
        res["plans"] = 0
        res["relocations"].clear()
        for k in kernels:
            k.launches = 0
        res["t0"] = time.perf_counter()

    engine.add_request = watched_add_request
    engine.step = watched_step
    runner._warmup = watched_warmup
    if apply_plan is not None:
        ce._apply_plan = watched_apply_plan
    summary = runner.run()
    _sync(device)
    wall = time.perf_counter() - res.pop("t0")
    totals = summary["totals"]
    res.update(
        summary=summary, wall_s=wall, counts={k.symbol: k.launches
                                              for k in kernels},
        graphs_end=len(graphs),
        moves=getattr(ce, "pending_moves", 0) - res["moves"],
        tok_s=totals["processed_tokens"] / totals["makespan_s"])
    if res["graphs_end"] != res["graphs_warm"]:
        raise AssertionError(
            f"{res['graphs_end'] - res['graphs_warm']} CUDA graphs were "
            "captured inside the timed run")
    return res


def check_static(res: dict, num_requests: int, prefill: int, decode: int,
                 tag: str) -> None:
    """A static trace of ``num_requests`` x (``prefill`` + ``decode``)
    tokens: every request done, none preempted, and the totals the
    trace's (the first token is sampled by the prompt's last chunk)."""
    t = res["summary"]["totals"]
    expect = dict(completed_requests=num_requests, preemptions=0,
                  processed_tokens=num_requests * (prefill + decode - 1),
                  decode_tokens=num_requests * (decode - 1))
    got = {k: t[k] for k in expect}
    if got != expect:
        raise AssertionError(f"({tag}) totals {got} != the trace's {expect}")
    lens = {len(v) for v in res["tokens"].values()}
    if len(res["tokens"]) != num_requests or lens != {decode}:
        raise AssertionError(f"({tag}) {len(res['tokens'])} requests "
                             f"returned tokens of lengths {lens}")


def replicas(engine_kwargs: dict, generator_config: dict,
             num_replicas: int) -> dict:
    """(r rep): ``num_replicas`` engines on one device, requests round
    robin; each replica completes its share, the merged totals are the
    sums, and the engines' device memory comes back when they are
    freed.  Returns the summary and the arenas' and memory's bytes."""
    device = resolve_device(engine_kwargs.get("device", "cuda"))
    free(device)
    before = (torch.cuda.memory_allocated(device)
              if device.type == "cuda" else 0)
    launcher = BenchmarkRunnerLauncher(
        engine_kwargs, "synthetic", generator_config,
        num_replicas=num_replicas)
    try:
        arenas = [r.engine.config.cache_config.memory_for_gpu
                  for r in launcher.runners]
        summary = launcher.run()
    finally:
        for r in launcher.runners:
            r.engine.cleanup()
        del launcher
        free(device)
    after = (torch.cuda.memory_allocated(device)
             if device.type == "cuda" else 0)
    n = generator_config["num_requests"]
    per = summary["per_replica_totals"]
    share = [len(range(r, n, num_replicas)) for r in range(num_replicas)]
    if [p["completed_requests"] for p in per] != share:
        raise AssertionError(f"(r rep) replicas completed "
                             f"{[p['completed_requests'] for p in per]}, "
                             f"not {share}")
    for key in ("completed_requests", "processed_tokens", "decode_tokens",
                "preemptions"):
        if summary["totals"][key] != sum(p[key] for p in per):
            raise AssertionError(f"(r rep) merged {key} "
                                 f"{summary['totals'][key]} is not the sum "
                                 f"of {[p[key] for p in per]}")
    if summary["totals"]["num_replicas"] != num_replicas:
        raise AssertionError("(r rep) the summary's num_replicas")
    return dict(summary=summary, arenas=arenas, allocated_before=before,
                allocated_after=after)


def from_yaml(config: Dict, directory: str, device: str,
              log: Callable[[str], None] = print) -> dict:
    """(r yaml): write ``config`` (nested sections overriding
    ``default.yml``) as a YAML file in ``directory`` and run it through
    ``ConfigParser`` and ``main.run_from_flat``, as ``python -m
    vattention_tpu_torch.benchmark.main --config_file <file>`` does."""
    import yaml

    from vattention_tpu_torch.benchmark.config import ConfigParser
    from vattention_tpu_torch.benchmark.main import run_from_flat

    path = os.path.join(directory, "benchmark.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    flat = ConfigParser().parse_args(["--config_file", path,
                                      "--device", device])
    log(f"(r yaml) {path}: " + ", ".join(
        f"{k} {flat[k]}" for k in ("model_name", "model_attention_backend",
                                   "synthetic_request_generator_num_requests",
                                   "fixed_request_length_generator_prefill_tokens",
                                   "fixed_request_length_generator_decode_tokens",
                                   "device")))
    return run_from_flat(flat)
