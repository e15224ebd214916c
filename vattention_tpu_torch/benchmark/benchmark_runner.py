"""Benchmark runner (ref: sarathi-lean/sarathi/benchmark/benchmark_runner.py:23-348).

Counterpart of ``vattention_tpu/benchmark/benchmark_runner.py``, with the
same arguments and summary keys.  Builds an engine from flags (on the GPU
unless ``engine_kwargs`` has ``device="cpu"``), synthesizes requests
(dummy token ids drawn as the JAX runner draws them, like the reference's
load_format=dummy path :115-131), adds them all with future arrival times,
and steps until done or the time limit.  The multi-replica launcher maps
to one engine per replica round-robin (ref :52,201-348); single replica is
the common path on one card.

The warm-up captures every step signature of a chunked-prefill run before
the timed loop, so no CUDA graph is captured inside it (a signature is
``(n_pre, POD flag, sampler mode)``, and its first step runs eagerly and
is captured, ``model_executor/model_runner.py``).  The JAX runner's one
request of 32 prompt tokens meets a prompt's step and a decode step; the
port's runner also admits a second request of 32 tokens after the first
one's prompt, so that one step mixes a decode with a prompt (the fused
signature of the POD backends; on the others the prompt's signature
again).  Its prompt is not drawn from the runner's generator, so the
timed run's prompts equal the JAX runner's.  Whole-prompt schedulers
(vllm, orca, faster_transformer) widen the prefill region for prompts
past the chunk, and such a width is captured when first met.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from vattention_tpu_torch.benchmark.request_generator.base import (
    Request, RequestGeneratorRegistry)
from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams
from vattention_tpu_torch.engine.llm_engine import LLMEngine
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.metrics.metrics_store import MetricsStore

logger = init_logger(__name__)

# the warm-up requests' prompt length
_WARMUP_TOKENS = 32


class BenchmarkRunner:
    def __init__(self, engine_kwargs: dict, generator_provider: str,
                 generator_config: dict, *,
                 time_limit_s: Optional[float] = None,
                 warmup: bool = True,
                 requests: Optional[List[Request]] = None,
                 enable_profiling: bool = False,
                 profiler_dir: str = "profiler_output"):
        self.engine = LLMEngine.from_engine_args(**engine_kwargs)
        self.generator = (None if requests is not None else
                          RequestGeneratorRegistry.get(
                              generator_provider, generator_config))
        self.requests = requests
        self.time_limit_s = time_limit_s or float("inf")
        self.warmup = warmup
        self.enable_profiling = enable_profiling
        self.profiler_dir = profiler_dir
        self.rng = np.random.default_rng(0)

    def _make_prompt(self, n: int) -> List[int]:
        return self.rng.integers(1, 1000, n).tolist()

    def _add_requests(self, requests: List[Request], base_time: float):
        for i, req in enumerate(requests):
            self.engine.add_request(
                prompt=None,
                prompt_token_ids=self._make_prompt(req.num_prefill_tokens),
                sampling_params=SamplingParams(
                    temperature=0.0, max_tokens=req.num_decode_tokens,
                    ignore_eos=True),
                arrival_time=base_time + req.arrival_time,
                seq_id=f"bench{i}")

    def _warmup(self) -> None:
        """ref :133-144 -- tiny requests through the engine to capture
        every step signature before timing (module docstring)."""
        greedy = SamplingParams(temperature=0.0, max_tokens=3,
                                ignore_eos=True)
        self.engine.add_request(
            prompt=None, prompt_token_ids=self._make_prompt(_WARMUP_TOKENS),
            sampling_params=greedy, seq_id="warmup")
        self.engine.step()
        self.engine.add_request(
            prompt=None,
            prompt_token_ids=list(range(1, _WARMUP_TOKENS + 1)),
            sampling_params=greedy, seq_id="warmup_mixed")
        while self.engine.has_unfinished_requests():
            self.engine.step()
        self.engine.reset_metrics()

    def run(self) -> dict:
        if self.warmup:
            self._warmup()
        if self.engine.config.metrics_config.enable_op_level_metrics:
            # per-op device rows (ref CudaTimer-per-op mode); measured
            # once at serving shapes, not per step
            self.engine.worker.profile_op_level()
        requests = (self.requests if self.requests is not None
                    else self.generator.generate())
        base = time.monotonic()
        self._add_requests(requests, base)
        num_steps = 0
        if self.enable_profiling:
            # ref benchmark_runner.py:147-179 (torch.profiler session)
            self.engine.worker.start_profiling(self.profiler_dir)
        t0 = time.monotonic()
        while self.engine.has_unfinished_requests():
            if time.monotonic() - t0 > self.time_limit_s:
                logger.warning("time limit hit with %d unfinished requests",
                               self.engine.get_num_unfinished_requests())
                break
            self.engine.step()
            num_steps += 1
        if self.enable_profiling:
            self.engine.worker.stop_profiling()
        store = self.engine.get_metric_store()
        summary = store.summary()
        summary["totals"]["num_steps"] = num_steps
        store.plot()
        return summary


class BenchmarkRunnerLauncher:
    """Multi-replica launcher (ref benchmark_runner.py:201-348).

    The reference places one Ray-actor runner per replica across the GPU
    cluster and round-robins requests (ref :52).  Here replicas are
    independent engines in one process; on a shared card their steps
    interleave and each sizes its KV arena from its share of
    ``gpu_memory_utilization`` (real deployments put each replica on its
    own card).  Each replica owns its metrics store; the stores are merged
    at the end.
    """

    def __init__(self, engine_kwargs: dict, generator_provider: str,
                 generator_config: dict, *, num_replicas: int = 1,
                 time_limit_s: Optional[float] = None, warmup: bool = True):
        self.num_replicas = num_replicas
        generator = RequestGeneratorRegistry.get(generator_provider,
                                                 generator_config)
        requests = generator.generate()
        # round-robin request assignment (ref :52)
        per_replica = [requests[r::num_replicas]
                       for r in range(num_replicas)]
        kwargs = dict(engine_kwargs)
        if num_replicas > 1:
            kwargs["gpu_memory_utilization"] = (
                kwargs.get("gpu_memory_utilization", 0.9) / num_replicas)
        self.runners = []
        self.replica_stores = []
        for r in range(num_replicas):
            if num_replicas > 1:
                # each replica owns its OWN metrics store (the reference
                # merges per-replica stores at run end, metrics_store.py
                # :867+); engine/worker/runner capture the fresh
                # singleton during construction
                MetricsStore._instance = None
            runner = BenchmarkRunner(
                kwargs, generator_provider, generator_config,
                time_limit_s=time_limit_s, warmup=warmup,
                requests=per_replica[r])
            self.runners.append(runner)
            self.replica_stores.append(runner.engine.get_metric_store())

    def run(self) -> dict:
        if self.num_replicas == 1:
            return self.runners[0].run()
        for runner in self.runners:
            if runner.warmup:
                runner._warmup()
        base = time.monotonic()
        for runner in self.runners:
            runner._add_requests(runner.requests, base)
        num_steps = 0
        live = list(self.runners)
        while live:
            for runner in list(live):
                if runner.engine.has_unfinished_requests():
                    runner.engine.step()
                    num_steps += 1
                else:
                    live.remove(runner)
        # merge replica stores into one aggregate (ref :867+)
        MetricsStore._instance = None
        agg = MetricsStore.get_or_create(
            self.runners[0].engine.config.metrics_config)
        for store in self.replica_stores:
            agg.merge(store)
        summary = agg.summary()
        summary["totals"]["num_steps"] = num_steps
        summary["totals"]["num_replicas"] = self.num_replicas
        summary["per_replica_totals"] = [
            store.summary()["totals"] for store in self.replica_stores]
        agg.plot()
        return summary
