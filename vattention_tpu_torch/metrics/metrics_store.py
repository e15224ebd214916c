"""Metrics store (ref: sarathi-lean/sarathi/metrics/metrics_store.py:66-924).

Singleton collecting request-, batch- and token-level distributions:
request e2e / scheduling delay / prefill-e2e / TBT, batch sizes & token
counts, step latency.  Outputs CSV summaries and (optionally) a chrome
trace of batches.  Plot/wandb layers of the reference map to the CSVs
(plotting is out of scope for the serving core).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from vattention_tpu_torch.config import MetricsConfig
from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


class DataSeries:
    """ref metrics/data_series.py (308 LoC): (x, y) series + quantiles."""

    def __init__(self, x_name: str, y_name: str):
        self.x_name = x_name
        self.y_name = y_name
        self.xs: List[float] = []
        self.ys: List[float] = []

    def put(self, x: float, y: float) -> None:
        self.xs.append(x)
        self.ys.append(y)

    def __len__(self) -> int:
        return len(self.ys)

    @property
    def sum(self) -> float:
        return float(np.sum(self.ys)) if self.ys else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.ys)) if self.ys else 0.0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.ys, q)) if self.ys else 0.0

    @property
    def max(self) -> float:
        return float(np.max(self.ys)) if self.ys else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": len(self.ys),
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": self.max,
            "sum": self.sum,
        }

    def to_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"{self.x_name},{self.y_name}\n")
            for x, y in zip(self.xs, self.ys):
                f.write(f"{x},{y}\n")


class CDFSketch(DataSeries):
    """Quantile sketch (ref cdf_sketch.py DDSketch) -- exact here."""

    def __init__(self, name: str):
        super().__init__("idx", name)

    def add(self, y: float) -> None:
        self.put(len(self.ys), y)


class MetricsStore:
    """Process singleton (ref metrics_store.py:66 + Singleton metaclass)."""

    _instance: Optional["MetricsStore"] = None

    def __init__(self, config: MetricsConfig):
        self.config = config
        self.enabled = config.write_metrics
        self.reset()

    @classmethod
    def get_or_create(cls, config: Optional[MetricsConfig] = None
                      ) -> "MetricsStore":
        if cls._instance is None:
            cls._instance = cls(config or MetricsConfig())
        return cls._instance

    @classmethod
    def get_instance(cls) -> "MetricsStore":
        return cls.get_or_create()

    def reset(self) -> None:
        self.request_e2e_time = CDFSketch("request_e2e_time")
        self.request_e2e_time_normalized = CDFSketch(
            "request_e2e_time_normalized")
        self.prefill_e2e_time = CDFSketch("prefill_e2e_time")
        self.scheduling_delay = CDFSketch("request_scheduling_delay")
        self.tbt = CDFSketch("decode_token_execution_plus_preemption_time")
        self.ttft = CDFSketch("time_to_first_token")
        self.batch_num_tokens = CDFSketch("batch_num_tokens")
        self.batch_size = CDFSketch("batch_size")
        self.batch_execution_time = CDFSketch("batch_execution_time")
        # per-op device times (OperationMetrics names; ref cuda_timer.py
        # attaches a CudaTimer per op -- here ops are measured in
        # isolation by metrics/op_profiler.py, since one fused XLA step
        # cannot be event-timed from Python)
        self.operation_times: Dict[str, CDFSketch] = {}
        # host-phase times (CpuOperationMetrics names: schedule,
        # prepare_inputs, kv_cache_step, ...)
        self.cpu_operation_times: Dict[str, CDFSketch] = {}
        # per-step allocator fragmentation fraction (BASELINE <1% target)
        self.fragmentation = CDFSketch("fragmentation_overhead")
        self.num_preempted = 0
        self.num_completed_requests = 0
        self.num_processed_tokens = 0
        self.num_decode_tokens = 0
        # phase-attributed wall time + workload integrals (the
        # per-phase roofline inputs, VERDICT r4 #3).  A step with any
        # prefill chunk counts as the "prefill" phase (MXU-bound side);
        # pure-decode steps are the "decode" phase (HBM-bound).  Under
        # async execution each inter-dispatch interval is attributed to
        # the previously dispatched step's phase -- in steady state the
        # host paces the device, and phases come in long runs, so the
        # <=max_inflight-step smear only touches phase boundaries.
        self.phase_stats = {
            "prefill_time_s": 0.0, "decode_time_s": 0.0,
            "prefill_steps": 0, "decode_steps": 0,
            "prefill_tokens": 0,
            # sum over prefill tokens of their kv depth (attention
            # flops integral: 4 * this * Hq * head_dim)
            "prefill_attn_weight": 0,
            "decode_tokens_prefill_steps": 0,
            "decode_tokens_decode_steps": 0,
            # sum of kv depths read by decode tokens, split by the
            # phase of the step they ran in
            "decode_kv_tokens_prefill_steps": 0,
            "decode_kv_tokens_decode_steps": 0,
        }
        self._pending_phase: Optional[str] = None
        self._last_dispatch_ts: Optional[float] = None
        self._last_batch_start: Optional[float] = None
        self._chrome_events: List[dict] = []
        self._run_start = time.monotonic()

    # ------------------------------------------------------------------ #
    # ingest hooks (ref :281-535)
    # ------------------------------------------------------------------ #
    def push_operation_time(self, op, seconds: float) -> None:
        """op: OperationMetrics member or its string value."""
        name = getattr(op, "value", op)
        sketch = self.operation_times.get(name)
        if sketch is None:
            sketch = self.operation_times[name] = CDFSketch(name)
        sketch.add(seconds)

    def push_cpu_operation_time(self, op, seconds: float) -> None:
        """op: CpuOperationMetrics member or its string value."""
        name = getattr(op, "value", op)
        sketch = self.cpu_operation_times.get(name)
        if sketch is None:
            sketch = self.cpu_operation_times[name] = CDFSketch(name)
        sketch.add(seconds)

    def on_request_arrival(self, seq) -> None:
        pass

    def on_request_end(self, seq) -> None:
        state = seq.state
        if state.e2e_time is not None:
            self.request_e2e_time.add(state.e2e_time)
            n = max(seq.get_len(), 1)
            self.request_e2e_time_normalized.add(state.e2e_time / n)
        if state.scheduling_delay is not None:
            self.scheduling_delay.add(state.scheduling_delay)
        if state.e2e_prefill_time is not None:
            self.prefill_e2e_time.add(state.e2e_prefill_time)
            # TTFT == arrival -> prompt-processing-complete (the first
            # output token is sampled by the prefill's final chunk)
            self.ttft.add(state.e2e_prefill_time)
        self.num_completed_requests += 1

    def on_batch_start(self) -> None:
        self._last_batch_start = time.monotonic()

    def on_step_dispatch(self, seq_metadata_list) -> None:
        """Phase accounting at dispatch time (see phase_stats above)."""
        now = time.monotonic()
        ps = self.phase_stats
        if self._pending_phase is not None \
                and self._last_dispatch_ts is not None:
            ps[f"{self._pending_phase}_time_s"] += \
                now - self._last_dispatch_ts
        self._last_dispatch_ts = now
        has_prefill = any(m.is_prompt for m in seq_metadata_list)
        phase = "prefill" if has_prefill else "decode"
        ps[f"{phase}_steps"] += 1
        for m in seq_metadata_list:
            if m.is_prompt:
                chunk = m.prompt_chunk_len
                kv_end = (m.seq.get_num_prompt_tokens_processed()
                          + chunk)
                ps["prefill_tokens"] += chunk
                ps["prefill_attn_weight"] += chunk * kv_end
            else:
                ps[f"decode_tokens_{phase}_steps"] += 1
                ps[f"decode_kv_tokens_{phase}_steps"] += m.seq.get_len()
        self._pending_phase = phase

    def on_batch_end(self, seq_metadata_list, scheduler_outputs) -> None:
        # core counters are kept even when metric output is disabled
        self.num_preempted += len(scheduler_outputs.preempted_seq_ids)
        for m in seq_metadata_list:
            if not m.is_prompt:
                self.num_decode_tokens += 1
        if not self.enabled:
            return
        now = time.monotonic()
        if self._last_batch_start is not None:
            dt = now - self._last_batch_start
            self.batch_execution_time.add(dt)
            if self.config.enable_chrome_trace:
                self._chrome_events.append({
                    "name": f"batch_{scheduler_outputs.id}",
                    "ph": "X", "pid": 0, "tid": 0,
                    "ts": int((self._last_batch_start - self._run_start)
                              * 1e6),
                    "dur": int(dt * 1e6),
                    "args": {
                        "batch_size": len(seq_metadata_list),
                        "num_tokens":
                            scheduler_outputs.num_batched_tokens,
                    },
                })
        self._last_batch_start = None
        num_tokens = sum(
            max(m.prompt_chunk_len, 1) for m in seq_metadata_list)
        self.batch_num_tokens.add(num_tokens)
        self.batch_size.add(len(seq_metadata_list))
        self.num_processed_tokens += num_tokens
        for m in seq_metadata_list:
            if not m.is_prompt:
                t = m.seq.state.last_token_generation_time
                if t > 0:
                    self.tbt.add(t)

    # ------------------------------------------------------------------ #
    def merge(self, other: "MetricsStore") -> None:
        """Merge a worker/replica store (ref :867+)."""
        for name in ("request_e2e_time", "request_e2e_time_normalized",
                     "prefill_e2e_time", "scheduling_delay", "tbt", "ttft",
                     "batch_num_tokens", "batch_size",
                     "batch_execution_time"):
            mine, theirs = getattr(self, name), getattr(other, name)
            mine.xs.extend(theirs.xs)
            mine.ys.extend(theirs.ys)
        for name, sketch in other.operation_times.items():
            for y in sketch.ys:
                self.push_operation_time(name, y)
        for name, sketch in other.cpu_operation_times.items():
            for y in sketch.ys:
                self.push_cpu_operation_time(name, y)
        self.fragmentation.ys.extend(other.fragmentation.ys)
        self.fragmentation.xs.extend(other.fragmentation.xs)
        self.num_preempted += other.num_preempted
        self.num_completed_requests += other.num_completed_requests
        self.num_processed_tokens += other.num_processed_tokens
        self.num_decode_tokens += other.num_decode_tokens
        for k, v in other.phase_stats.items():
            self.phase_stats[k] += v
        # aggregate wall clock spans every merged replica's run
        self._run_start = min(self._run_start, other._run_start)

    def summary(self) -> Dict[str, Dict[str, float]]:
        wall = time.monotonic() - self._run_start
        out = {
            name: getattr(self, name).summary()
            for name in ("request_e2e_time", "request_e2e_time_normalized",
                         "prefill_e2e_time", "scheduling_delay", "tbt",
                         "ttft", "batch_num_tokens", "batch_size",
                         "batch_execution_time")
        }
        if self.operation_times:
            out["operation_times"] = {
                name: sketch.summary()
                for name, sketch in sorted(self.operation_times.items())}
        if self.cpu_operation_times:
            out["cpu_operation_times"] = {
                name: sketch.summary()
                for name, sketch in sorted(
                    self.cpu_operation_times.items())}
        if len(self.fragmentation):
            out["fragmentation_overhead"] = self.fragmentation.summary()
        out["totals"] = {
            "wall_time_s": wall,
            "completed_requests": self.num_completed_requests,
            "processed_tokens": self.num_processed_tokens,
            "decode_tokens": self.num_decode_tokens,
            "preemptions": self.num_preempted,
            "tokens_per_s": (self.num_processed_tokens / wall
                             if wall > 0 else 0.0),
            "makespan_s": self.request_e2e_time.max,
        }
        out["phase_stats"] = dict(self.phase_stats)
        return out

    def plot(self) -> None:
        """Write CSVs + summary json (+ chrome trace) to output_dir."""
        if not self.enabled:
            return
        os.makedirs(self.config.output_dir, exist_ok=True)
        for name in ("request_e2e_time", "request_e2e_time_normalized",
                     "prefill_e2e_time", "scheduling_delay", "tbt", "ttft",
                     "batch_num_tokens", "batch_size",
                     "batch_execution_time"):
            getattr(self, name).to_csv(
                os.path.join(self.config.output_dir, f"{name}.csv"))
        for name, sketch in {**self.operation_times,
                             **self.cpu_operation_times}.items():
            sketch.to_csv(os.path.join(self.config.output_dir,
                                       f"operation_{name}.csv"))
        if len(self.fragmentation):
            self.fragmentation.to_csv(os.path.join(
                self.config.output_dir, "fragmentation_overhead.csv"))
        with open(os.path.join(self.config.output_dir,
                               "summary.json"), "w") as f:
            json.dump(self.summary(), f, indent=2)
        if self.config.enable_chrome_trace and self._chrome_events:
            with open(os.path.join(self.config.output_dir,
                                   "chrome_trace.json"), "w") as f:
                json.dump({"traceEvents": self._chrome_events}, f)
        if getattr(self.config, "enable_plots", False):
            self._write_plots()
        logger.info("metrics written to %s", self.config.output_dir)

    def _write_plots(self) -> None:
        """Per-metric cdf + histogram PNGs (ref metrics_store.py:243-264
        writes the same per-distribution figures through plotly/wandb;
        matplotlib-Agg here, one 2-panel figure per metric)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        series = {
            name: getattr(self, name)
            for name in ("request_e2e_time", "request_e2e_time_normalized",
                         "prefill_e2e_time", "scheduling_delay", "tbt",
                         "ttft", "batch_num_tokens", "batch_size",
                         "batch_execution_time")
        }
        series.update({f"operation_{k}": v
                       for k, v in self.operation_times.items()})
        for name, s in series.items():
            if len(s) < 2:
                continue
            ys = np.sort(np.asarray(s.ys, dtype=np.float64))
            fig, (ax_cdf, ax_hist) = plt.subplots(
                1, 2, figsize=(8, 3), constrained_layout=True)
            ax_cdf.plot(ys, np.arange(1, len(ys) + 1) / len(ys),
                        drawstyle="steps-post")
            ax_cdf.set_xlabel(s.y_name)
            ax_cdf.set_ylabel("cdf")
            ax_hist.hist(ys, bins=min(50, max(10, len(ys) // 5)))
            ax_hist.set_xlabel(s.y_name)
            ax_hist.set_ylabel("count")
            fig.suptitle(name)
            fig.savefig(os.path.join(self.config.output_dir,
                                     f"{name}.png"), dpi=110)
            plt.close(fig)
