"""Sampling parameters (ref: sarathi-lean/sarathi/core/datatypes/sampling_params.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

_SAMPLING_EPS = 1e-5


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    stop: Union[str, List[str], None] = None
    ignore_eos: bool = False
    max_tokens: int = 16

    def __post_init__(self):
        if self.stop is None:
            self.stop = []
        elif isinstance(self.stop, str):
            self.stop = [self.stop]
        else:
            self.stop = list(self.stop)
        self._verify_args()

    def _verify_args(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be non-negative, got {self.temperature}.")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}.")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError(
                f"top_k must be -1 (disable) or at least 1, got {self.top_k}.")
        if self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be at least 1, got {self.max_tokens}.")

    @property
    def is_greedy(self) -> bool:
        return self.temperature < _SAMPLING_EPS
