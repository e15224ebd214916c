"""Request generators: interval x length composition.

Counterpart of ``vattention_tpu/benchmark/request_generator/base.py``,
numpy only: the same config draws the same ``Request`` list, float for
float (``default_rng(seed)`` per generator, the same trace clamps).

ref: sarathi-lean/sarathi/benchmark/request_generator/* -- registry
pattern composing interval generators {static, poisson, gamma, trace}
with length generators {fixed, uniform, zipf, trace} into synthetic
request streams, plus full trace replay
(synthetic_request_generator.py:16-103, trace_replay_request_generator.py).
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    arrival_time: float
    num_prefill_tokens: int
    num_decode_tokens: int


# ------------------------- interval generators ------------------------- #
class BaseIntervalGenerator:
    def __init__(self, config):
        self.config = config

    def get_next_inter_request_time(self) -> Optional[float]:
        raise NotImplementedError


class StaticIntervalGenerator(BaseIntervalGenerator):
    """All requests arrive at t=0 (static trace)."""

    def get_next_inter_request_time(self) -> float:
        return 0.0


class PoissonIntervalGenerator(BaseIntervalGenerator):
    """ref poisson_request_interval_generator.py:21."""

    def __init__(self, config):
        super().__init__(config)
        self.qps = config["qps"]
        self.rng = np.random.default_rng(config.get("seed", 0))

    def get_next_inter_request_time(self) -> float:
        return float(self.rng.exponential(1.0 / self.qps))


class GammaIntervalGenerator(BaseIntervalGenerator):
    def __init__(self, config):
        super().__init__(config)
        self.qps = config["qps"]
        self.cv = config.get("cv", 0.5)
        self.rng = np.random.default_rng(config.get("seed", 0))
        self.shape = 1.0 / (self.cv ** 2)
        self.scale = self.cv ** 2 / self.qps

    def get_next_inter_request_time(self) -> float:
        return float(self.rng.gamma(self.shape, self.scale))


# -------------------------- length generators -------------------------- #
class BaseLengthGenerator:
    def __init__(self, config):
        self.config = config

    def get_next_num_tokens(self):
        """-> (num_prefill_tokens, num_decode_tokens)"""
        raise NotImplementedError


class FixedLengthGenerator(BaseLengthGenerator):
    def get_next_num_tokens(self):
        return (self.config["prefill_tokens"],
                self.config["decode_tokens"])


class UniformLengthGenerator(BaseLengthGenerator):
    def __init__(self, config):
        super().__init__(config)
        self.rng = np.random.default_rng(config.get("seed", 0))

    def get_next_num_tokens(self):
        total = int(self.rng.integers(self.config["min_tokens"],
                                      self.config["max_tokens"] + 1))
        pd = self.config.get("prefill_to_decode_ratio", 8.0)
        decode = max(1, int(total / (1 + pd)))
        return total - decode, decode


class ZipfLengthGenerator(BaseLengthGenerator):
    """ref utils/zipf_generator.py:6-46 (bounded zipf with theta)."""

    def __init__(self, config):
        super().__init__(config)
        self.theta = config.get("theta", 0.6)
        self.scramble = config.get("scramble", False)
        self.min = config["min_tokens"]
        self.max = config["max_tokens"]
        self.rng = np.random.default_rng(config.get("seed", 0))
        self.items = self.max - self.min + 1
        self.zeta2 = self._zeta(2, self.theta)
        self.alpha = 1.0 / (1.0 - self.theta)
        self.zetan = self._zeta(self.items, self.theta)
        self.eta = ((1 - math.pow(2.0 / self.items, 1 - self.theta))
                    / (1 - self.zeta2 / self.zetan))

    @staticmethod
    def _zeta(count, theta):
        return sum(1.0 / math.pow(i + 1, theta) for i in range(count))

    def _next(self):
        u = self.rng.random()
        uz = u * self.zetan
        if uz < 1.0:
            return self.min
        if uz < 1.0 + math.pow(0.5, self.theta):
            return self.min + 1
        v = self.min + int(self.items
                           * math.pow(self.eta * u - self.eta + 1,
                                      self.alpha))
        if self.scramble:
            v = self.min + (hash(v) % self.items)
        return min(max(v, self.min), self.max)

    def get_next_num_tokens(self):
        total = self._next()
        pd = self.config.get("prefill_to_decode_ratio", 8.0)
        decode = max(1, int(total / (1 + pd)))
        return total - decode, decode


class TraceLengthGenerator(BaseLengthGenerator):
    """CSV trace with num_prefill_tokens/num_decode_tokens columns plus
    scale factors (ref trace_request_length_generator.py; schema
    data/processed_traces/arxiv_*.csv)."""

    def __init__(self, config):
        super().__init__(config)
        self.rows: List[tuple] = []
        prefill_scale = config.get("prefill_scale_factor", 1.0)
        decode_scale = config.get("decode_scale_factor", 1.0)
        max_tokens = config.get("max_tokens", 1 << 30)
        with open(config["trace_file"]) as f:
            for row in csv.DictReader(f):
                p = int(float(row["num_prefill_tokens"]) * prefill_scale)
                d = int(float(row["num_decode_tokens"]) * decode_scale)
                p = max(1, min(p, max_tokens - 1))
                d = max(1, min(d, max_tokens - p))
                self.rows.append((p, d))
        self.rng = np.random.default_rng(config.get("seed", 0))
        self.idx = 0

    def get_next_num_tokens(self):
        row = self.rows[self.idx % len(self.rows)]
        self.idx += 1
        return row


# ----------------------------- composition ----------------------------- #
_INTERVAL = {
    "static": StaticIntervalGenerator,
    "poisson": PoissonIntervalGenerator,
    "gamma": GammaIntervalGenerator,
}
_LENGTH = {
    "fixed": FixedLengthGenerator,
    "uniform": UniformLengthGenerator,
    "zipf": ZipfLengthGenerator,
    "trace": TraceLengthGenerator,
}


class SyntheticRequestGenerator:
    """ref synthetic_request_generator.py:16-103."""

    def __init__(self, interval_type: str, length_type: str, config: dict):
        self.interval = _INTERVAL[interval_type](config)
        self.length = _LENGTH[length_type](config)
        self.num_requests = config["num_requests"]

    def generate(self) -> List[Request]:
        requests = []
        t = 0.0
        for _ in range(self.num_requests):
            t += self.interval.get_next_inter_request_time()
            p, d = self.length.get_next_num_tokens()
            requests.append(Request(t, p, d))
        return requests


class TraceReplayRequestGenerator:
    """Replay arrival times + lengths from a CSV trace."""

    def __init__(self, config: dict):
        self.config = config
        self.rows: List[Request] = []
        time_scale = config.get("time_scale_factor", 1.0)
        max_tokens = config.get("max_tokens") or (1 << 30)
        with open(config["trace_file"]) as f:
            for row in csv.DictReader(f):
                p = min(int(row["num_prefill_tokens"]), max_tokens - 1)
                d = min(int(row["num_decode_tokens"]), max_tokens - p)
                self.rows.append(Request(
                    float(row.get("arrival_time", 0.0)) * time_scale,
                    p, max(1, d)))
        if config.get("num_requests"):
            self.rows = self.rows[:config["num_requests"]]

    def generate(self) -> List[Request]:
        return list(self.rows)


class RequestGeneratorRegistry:
    @staticmethod
    def get(provider: str, config: dict):
        if provider == "synthetic":
            return SyntheticRequestGenerator(
                config.get("interval_generator", "static"),
                config.get("length_generator", "fixed"), config)
        if provider == "trace_replay":
            return TraceReplayRequestGenerator(config)
        raise ValueError(f"unknown request generator provider {provider!r}")
