"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name (``port_bench/cells.py``).  The run builds
the port's engine with the seed's weights, warms it up, ramps the
traffic, serves ``--seconds`` of it in the window, and then decides
``correct`` by running the plain float32 reference over a sample of the
served requests (``port_bench/reference/``) once the engine is freed.
``--trace 1`` runs the window under ``torch.profiler`` and reports the
per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number compared with its
limit.  The numbers compared are also the last lines of standard error.
Earlier lines: the card's name, clocks and power, the set-up's parts,
the counts behind each metric.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), without the port's package, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T0 = time.monotonic()   # the process's start, for setup_s

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from port_bench import cells, counts, tails  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vattention_tpu")
DRAIN_LIMIT_S = 120.0


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class RunData:
    """What the metric readers read."""
    cell: "cells.Cell"
    dims: counts.Dims
    setup_s: float
    t_open: float
    t_close: float
    records: list
    steps: List[counts.Step]          # dispatched in the window
    kv_step_s: List[float]            # the cache engine's step, window
    summary: object = None            # trace.Summary of a traced window

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def slot_classes(slots, batch: int) -> list:
    """The halves of the decode batch that a fault could leave out: the
    even and the odd slots, each in the lower and the upper half of the
    batch's ``batch`` rows and of the rows in use (``slots``)."""
    live = max(slots) + 1
    classes = []
    for top in sorted({batch, live}):
        for parity in (0, 1):
            for upper in (False, True):
                cls = frozenset(s for s in slots if s % 2 == parity
                                and (2 * s >= top) == upper)
                if cls and cls not in classes:
                    classes.append(cls)
    return classes


def sample(records, seed: int, check_cfg: dict, batch: int) -> list:
    """The finished requests to compare: the ``longest`` with the most
    served tokens, ``random`` more drawn from the seed, and with
    ``cover`` one more, drawn from the seed, for each class of slots
    (``slot_classes``) that no request chosen sat in, among those of at
    most ``cover_positions`` prompt and served tokens where the class has
    any; so a fault that leaves out half of the batch meets the sample
    whichever half it is."""
    longest = int(check_cfg.get("longest", 1))
    random = int(check_cfg.get("random", 0))
    done = sorted((r for r in records if r.tokens),
                  key=lambda r: (-len(r.tokens), -r.req.prompt_len,
                                 r.req.rid))
    chosen = done[:longest]
    rest = done[longest:]
    rng = np.random.default_rng([seed % (1 << 64), 99])
    if rest and random:
        pick = rng.choice(len(rest), size=min(random, len(rest)),
                          replace=False)
        chosen += [rest[i] for i in sorted(pick)]
    slots = {r.slot for r in done if r.slot is not None}
    if check_cfg.get("cover") and slots:
        cap = check_cfg.get("cover_positions")
        cost = lambda r: r.req.prompt_len + len(r.tokens)  # noqa: E731
        for cls in slot_classes(slots, batch):
            if any(r.slot in cls for r in chosen):
                continue
            cands = [r for r in done if r.slot in cls and r not in chosen]
            cheap = [r for r in cands if cap is None or cost(r) <= cap]
            cheap = cheap or [min(cands, key=cost)]
            chosen.append(cheap[int(rng.integers(len(cheap)))])
    return chosen


def compare(cell, chosen, traffic, seed: int, device: str) -> Dict:
    """The reference's readings over the sample (the program is freed)."""
    import torch

    from port_bench import weights
    from port_bench.reference import check

    check.allow_tf32(False)
    dtype = getattr(torch, cell.engine_kwargs.get("dtype", "bfloat16"))
    w = dict(weights.all_weights(cell, seed, torch.device(device), dtype))
    ref = cell.reference().Reference(cell.config, w)
    readings = []
    for rec in chosen:
        served = check.Served(
            prompt=traffic.token_ids(rec.req, cell.dims.vocab),
            tokens=rec.tokens, logprobs=rec.logprobs)
        readings.append(check.read(ref, served, device))
        log(f"# request {rec.req.rid} slot {rec.slot} prompt "
            f"{rec.req.prompt_len} served {len(rec.tokens)}: "
            + " ".join(f"{k} {v}" for k, v in readings[-1].items()))
    del ref, w
    return check.combine(readings)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", kv_quant: Optional[str] = None,
            root: Path = cells.ROOT, bench: Optional[Path] = None,
            do_check: bool = True, traffic_overrides: Optional[dict] = None,
            t_start: Optional[float] = None) -> tuple:
    """One run of ``workload``: (the result object, its ``compared``
    last; the counts behind it).  ``kv_quant`` switches on the program's
    1-byte K/V (the control); ``traffic_overrides`` changes the mix's
    parameters (the knee sweep)."""
    import torch

    from port_bench import serve
    from port_bench.generator import Traffic
    from port_bench.reference import check

    cell = cells.load_cell(workload, trace, bench=bench, root=root)
    on_gpu = device != "cpu"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    t_start = T0 if t_start is None else t_start
    t = time.monotonic()
    log(f"# setup imports {t - t_start:.3f} s")
    engine = serve.build_engine(cell, device, seed, kv_quant=kv_quant)
    log(f"# setup engine+weights+warm-up {time.monotonic() - t:.3f} s "
        f"(since start {time.monotonic() - t_start:.3f} s)")
    traffic = Traffic({**cell.traffic, **(traffic_overrides or {})}, seed,
                      root)
    run, clients = measure(cell, engine, traffic, seconds, trace, device,
                           t_start)
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    if on_gpu:
        log(f"# smi after the window: {smi()}")
    metrics = {}
    for m in cell.metrics:
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    info = window_counts(run, len(clients.records))
    info.update(kv_held(run, clients, engine))
    log("# " + " ".join(f"{k} {v}" for k, v in info.items()))

    check_cfg = cell.workload["check"]
    if check_cfg.get("drain"):
        t = time.monotonic()
        clients.drain(DRAIN_LIMIT_S)
        log(f"# drain {time.monotonic() - t:.3f} s")
    records = list(clients.records.values())
    chosen = sample(records, seed, check_cfg,
                    int(cell.engine_kwargs.get("max_batch_size", 1)))
    attempted = sum(1 for r in records if r.due < run.t_close)
    failed = sum(1 for r in records
                 if r.tokens and len(r.tokens) != r.req.max_tokens)
    serve.free_engine(engine)
    del engine, clients
    numbers: Dict[str, float] = {}
    if do_check and chosen:
        t = time.monotonic()
        free_device(on_gpu)
        numbers = compare(cell, chosen, traffic, seed, device)
        log(f"# reference over {len(chosen)} requests "
            f"({numbers.get('tokens')} served tokens, "
            f"{sum(r.req.prompt_len + len(r.tokens) for r in chosen)} "
            f"positions; slots {sorted({r.slot for r in chosen})}) "
            f"in {time.monotonic() - t:.3f} s")
    free_device(on_gpu)
    limits = check_cfg["limits"]
    correct = bool(do_check and chosen and failed == 0
                   and check.verdict(numbers, limits))

    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name() if on_gpu else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        result["breakdown"] = {"device_ops": run.summary.top_ops,
                               "idle_gaps": run.summary.idle_gaps}
    result["compared"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                          for k in limits}
    result["compared"]["requests"] = len(chosen)
    result["compared"]["tokens"] = numbers.get("tokens", 0)
    info["numbers"] = numbers
    return result, info


def measure(cell, engine, traffic, seconds: float, trace: bool,
            device: str, t_start: float) -> tuple:
    """The ramp and the window (under the profiler with ``trace``):
    (RunData, the clients)."""
    from port_bench import serve, trace as tr

    span = window_span = prof = summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        names = {"step": tr.STEP, "admit": tr.ADMIT, "wait": tr.WAIT}
        span = lambda name: record_function(names[name])  # noqa: E731
        window_span = record_function(tr.WINDOW)
    clients = serve.Clients(engine, traffic, cell.dims.vocab,
                            device, span=span)
    t = time.monotonic()
    clients.ramp(seconds)
    log(f"# setup ramp {time.monotonic() - t:.3f} s")
    if trace:
        activities = [ProfilerActivity.CPU]
        if device != "cpu":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    timer = engine.get_metric_store().cpu_operation_times
    kv0 = len(timer["kv_cache_step"].ys) if "kv_cache_step" in timer else 0
    clients.window(seconds, window_span)
    kv_step = (list(timer["kv_cache_step"].ys[kv0:])
               if "kv_cache_step" in timer else [])
    if prof is not None:
        prof.__exit__(None, None, None)
        t = time.monotonic()
        summary = tr.summarize(prof)
        log(f"# trace read in {time.monotonic() - t:.3f} s")
    clients.note_delays()
    run = RunData(cell, cell.dims,
                  clients.t_open - t_start, clients.t_open, clients.t_close,
                  list(clients.records.values()), clients.window_steps(),
                  kv_step, summary)
    return run, clients


def window_counts(run: RunData, sent: int) -> dict:
    """The counts behind the metrics, for the log and the calibration."""
    recs = run.records
    return {
        "window_s": run.window_s, "setup_s": run.setup_s,
        "steps": len(run.steps), "tokens": tails.window_tokens(run.steps),
        "sent": sent,
        "due_in_window": sum(1 for r in recs
                             if run.t_open <= r.due < run.t_close),
        "finished_in_window": sum(
            1 for r in recs
            if r.finished_at is not None and r.finished_at < run.t_close),
        "unanswered_at_close": tails.unanswered(recs, run.t_open,
                                                run.t_close),
        "ttft_p90_s": tails.percentile(tails.first_token_waits(
            recs, run.t_open, run.t_close), 90),
        "tbt_p95_ms": (tails.percentile(tails.token_gaps(
            recs, run.t_open, run.t_close), 95) or 0.0) * 1e3,
    }


def kv_held(run: RunData, clients, engine) -> dict:
    """The K/V the live sequences held at their peak, beside the arena the
    engine reserved: the peak of ``memory_peak_bytes`` counts the whole
    reservation, held or not."""
    per_token = counts.kv_bytes_per_token(run.dims)
    window = max((s.held for s in run.steps), default=0)
    whole = max((s.held for s in clients.steps), default=0)
    arena = engine.worker.cache_engine.kv_cache
    return {"kv_held_peak_tokens": window,
            "kv_held_peak_bytes": window * per_token,
            "kv_held_peak_bytes_run": whole * per_token,
            "arena_bytes": arena.numel() * arena.element_size()}


def free_device(on_gpu: bool) -> None:
    gc.collect()
    if on_gpu:
        import torch
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = cells.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"error: the cell needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import vattention_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"error: the port's package is missing: {e}")
        return 2
    result, _ = execute(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"error: loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in result["compared"].items():
        if isinstance(c, dict):
            log(f"compared {name} {c['value']} limit {c['limit']}")
        else:
            log(f"compared {name} {c}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
