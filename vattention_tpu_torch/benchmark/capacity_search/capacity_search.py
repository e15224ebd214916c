"""Capacity search: max sustainable QPS under latency SLOs.

Counterpart of ``vattention_tpu/benchmark/capacity_search/capacity_search.py``
(ref: sarathi-lean/sarathi/benchmark/capacity_search/capacity_search.py:
72-244) -- bisection on Poisson arrival rate until the highest qps whose
scheduling-delay / TBT quantiles meet the SLO is found.  The reference
fans configurations out over a Ray cluster; here each probe is one
benchmark run on the local card (replica fan-out composes at the script
level).

One deliberate difference from the JAX package: the growth loop keeps its
last probe's result, and the search stops early with "SLO never bound"
only if the probe at the cap (64 qps) passed.  When that probe fails, the
SLO did bind and the search bisects between the last passing rate and
64; the JAX package returns the last passing rate there and under-reports
capacity by up to 2x.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)

# the growth loop's cap: past it the workload is too small to queue
_QPS_CAP = 64


@dataclass
class SLOConfig:
    """ref capacity_search config: scheduling-delay / TBT SLO quantiles."""

    scheduling_delay_slo_s: float = 2.0
    scheduling_delay_quantile: float = 0.99
    tbt_slo_s: Optional[float] = None
    tbt_quantile: float = 0.99


class CapacitySearch:
    def __init__(self, engine_kwargs: dict, generator_config: dict,
                 slo: SLOConfig, *, num_requests: int = 64,
                 time_limit_s: float = 600.0):
        self.engine_kwargs = engine_kwargs
        self.generator_config = dict(generator_config)
        self.slo = slo
        self.num_requests = num_requests
        self.time_limit_s = time_limit_s
        # probe history (qps, measured delay quantile, slo_ok) -- kept so
        # the committed artifact shows the evidence behind the bisection,
        # not just its endpoint.
        self.probes: list[dict] = []

    def _probe(self, qps: float) -> bool:
        """Run one benchmark at ``qps``; True iff SLOs hold."""
        from vattention_tpu_torch.benchmark.benchmark_runner import (
            BenchmarkRunner)
        from vattention_tpu_torch.metrics.metrics_store import MetricsStore

        MetricsStore._instance = None
        cfg = dict(self.generator_config)
        cfg.update(qps=qps, num_requests=self.num_requests,
                   interval_generator="poisson")
        runner = BenchmarkRunner(
            dict(self.engine_kwargs, write_metrics=True), "synthetic",
            cfg, time_limit_s=self.time_limit_s)
        try:
            summary = runner.run()
        finally:
            runner.engine.cleanup()
        delay_q = summary["scheduling_delay"]
        ok = True
        q = int(self.slo.scheduling_delay_quantile * 100)
        delay = delay_q.get(f"p{q}", delay_q.get("p99", 0.0))
        if delay > self.slo.scheduling_delay_slo_s:
            ok = False
        if self.slo.tbt_slo_s is not None:
            tbt = summary["tbt"].get("p99", 0.0)
            if tbt > self.slo.tbt_slo_s:
                ok = False
        logger.info("probe qps=%.2f -> delay_p%d=%.2fs slo_ok=%s",
                    qps, q, delay, ok)
        self.probes.append({
            "qps": qps, f"delay_p{q}": round(delay, 3),
            "tokens_per_s": round(
                summary["totals"].get("tokens_per_s", 0.0), 1),
            "slo_ok": ok,
        })
        return ok

    def search(self, qps_low: float = 0.25, qps_high: float = 16.0,
               tolerance: float = 0.25, max_iters: int = 8) -> float:
        """Bisection (ref capacity_search.py:106-244): largest qps whose
        probe meets the SLO, to within ``tolerance``."""
        if not self._probe(qps_low):
            logger.warning("SLO violated even at qps=%.2f", qps_low)
            return 0.0
        # grow the upper bound until a probe fails, up to the cap (if the
        # SLO never binds the workload is too small to queue --
        # num_requests must be >> max_batch_size for the search to mean
        # anything)
        ok = self._probe(qps_high)
        while ok and qps_high < _QPS_CAP:
            qps_low = qps_high
            qps_high *= 2
            ok = self._probe(qps_high)
        if ok:
            logger.warning(
                "SLO never bound up to qps=%.0f -- workload too small "
                "to build a queue; raise num_requests", qps_high)
            return qps_low
        it = 0
        while qps_high - qps_low > tolerance and it < max_iters:
            mid = (qps_low + qps_high) / 2
            if self._probe(mid):
                qps_low = mid
            else:
                qps_high = mid
            it += 1
        return qps_low
