"""The one traffic generator: reads a mix's data file, draws requests from a seed.

A mix (``port_bench/traffic/<name>.json``) is parameters only:

- ``kind``: how requests are sent, found by name in
  ``traffic/kinds/<kind>.py``: ``closed_loop`` (``clients`` callers, each
  sends its next request when the last one has finished; ``pool``,
  ``residual_start``) or ``poisson_open`` (independent users arriving at
  ``rate`` requests a second; ``ramp_s`` seconds of arrivals before the
  window opens, so that the window starts loaded).  A kind file gives
  ``CLOSED`` and, closed, ``first_requests(t)`` and
  ``next_request(t, client)``, or, open, ``arrivals(t, seconds)``.
- lengths: ``prompt`` and ``output`` as ``{<dist>: args}``, each
  distribution found by name in ``traffic/dists/<dist>.py``
  (``uniform``), or ``output`` as ``{"per_prompt": r}`` (output = prompt
  x r); or ``lengths`` as ``{"trace": <csv under port_bench/>}`` (rows of
  ``num_prefill_tokens,num_decode_tokens``).

Every seed gets the same requests in the same order, and the seed draws
only their token ids (from the seed and the request's index) and the
weights: a distribution is cut into a pool of equal-probability strata
(the midpoint of each), a trace into rows at evenly spaced quantiles of
prompt length, and Poisson gaps into exponential quantiles, and each
pool is shuffled once by a fixed key.  Runs in which the seed ordered
the pool spread by 2.2-2.4% in processed tokens a second where two runs
of one seed agreed within 0.15%: in a window of one and a half rounds of
a closed loop, the order sets which depths the window holds.  So the
work in a window does not change with the seed.

The arithmetic of the uniform, Poisson and trace draws follows
``vattention_tpu_torch/benchmark/request_generator/base.py`` (its
``UniformLengthGenerator``, ``PoissonIntervalGenerator`` and
``TraceLengthGenerator``), copied here and stratified.  The arxiv trace
under ``data/`` is the repository's
``data/processed_traces/arxiv_synthetic_v2.csv``, copied unchanged.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from port_bench.cells import load_module

# the key that shuffles every pool, the same for every run
SHUFFLE_SEED = 0

# a fixed stride that pairs the i-th prompt stratum with an output
# stratum, so that the pairs are one set for every seed
_PAIR_STRIDE = 7


@dataclass
class Request:
    rid: int                 # index in the run, names the token draw
    prompt_len: int
    max_tokens: int
    client: int = -1         # closed loop: the caller; open loop: -1
    due: Optional[float] = None  # open loop: seconds after the window opens


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *key])


def strata(lo: int, hi: int, n: int) -> List[int]:
    """``n`` equal-probability strata of uniform [lo, hi], each its
    midpoint, rounded."""
    return [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def trace_rows(path: Path, n: int) -> List[Tuple[int, int]]:
    """``n`` rows of the trace at evenly spaced quantiles of prompt
    length (the clamps of ``TraceLengthGenerator``: at least one token
    each)."""
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append((max(1, int(float(row["num_prefill_tokens"]))),
                         max(1, int(float(row["num_decode_tokens"])))))
    rows.sort()
    return [rows[min(len(rows) - 1, int((i + 0.5) * len(rows) / n))]
            for i in range(n)]


def exp_gaps(rate: float, n: int, span: float) -> List[float]:
    """``n`` Poisson inter-arrival gaps: the exponential's quantiles at
    the strata midpoints, scaled so that the ``n`` arrivals end one mean
    gap before ``span`` seconds."""
    q = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    scale = span * n / (n + 1) / sum(q)
    return [g * scale for g in q]

class Traffic:
    """A mix's requests for one seed."""

    def __init__(self, params: dict, seed: int, root: Path):
        self.params = params
        self.seed = seed
        self.root = root
        self.kind = params["kind"]
        try:
            self._kind = load_module(root / "traffic" / "kinds" /
                                     f"{self.kind}.py", "traffic kind")
        except KeyError as e:
            raise ValueError(f"unknown traffic kind {self.kind!r}") from e
        self.closed = bool(self._kind.CLOSED)
        self._next_rid = 0
        if hasattr(self._kind, "setup"):
            self._kind.setup(self)

    # ------------------------------------------------------------------ #
    # for the kinds
    def sizes(self, n: int) -> List[Tuple[int, int]]:
        """``n`` (prompt, output) pairs, one set for every seed."""
        p = self.params
        if "lengths" in p:
            return trace_rows(self.root / p["lengths"]["trace"], n)
        prompts = self._dist(p["prompt"], n)
        out = p["output"]
        if "per_prompt" in out:
            return [(x, max(1, int(round(x * out["per_prompt"]))))
                    for x in prompts]
        outs = self._dist(out, n)
        stride = _PAIR_STRIDE if math.gcd(_PAIR_STRIDE, n) == 1 else 1
        return [(prompts[i], outs[(i * stride) % n]) for i in range(n)]

    def _dist(self, spec: dict, n: int) -> List[int]:
        (name, args), = spec.items()
        dist = load_module(self.root / "traffic" / "dists" / f"{name}.py",
                           "length distribution")
        return [int(x) for x in dist.sizes(args, n)]

    @staticmethod
    def permuted(items: Sequence, key: int) -> list:
        """``items`` shuffled by a fixed key, the same for every seed."""
        order = _rng(SHUFFLE_SEED, key).permutation(len(items))
        return [items[i] for i in order]

    def request(self, prompt: int, out: int, **kw) -> Request:
        r = Request(self._next_rid, prompt, out, **kw)
        self._next_rid += 1
        return r

    # ------------------------------------------------------------------ #
    def token_ids(self, req: Request, vocab: int) -> List[int]:
        return _rng(self.seed, 2, req.rid).integers(
            0, vocab, req.prompt_len).tolist()

    def first_requests(self) -> List[Request]:
        """Closed loop: each client's first request."""
        return self._kind.first_requests(self)

    def next_request(self, client: int) -> Request:
        """Closed loop: the next request of ``client``."""
        return self._kind.next_request(self, client)

    def arrivals(self, seconds: float) -> List[Request]:
        """Open loop: the requests due before the window (due < 0) and in
        it, due in seconds after it opens."""
        return self._kind.arrivals(self, seconds)


def open_arrivals(t: Traffic, seconds: float,
                  gaps: Callable[[float, int, float], List[float]]
                  ) -> List[Request]:
    """An open loop at ``rate``: ``ramp_s`` seconds of arrivals before the
    window (due before 0) and ``seconds`` of them in it, each a fixed set
    of sizes and of ``gaps(rate, n, span)``, in a fixed order."""
    p = t.params
    rate = float(p["rate"])
    ramp_s = float(p.get("ramp_s", 0.0))
    reqs = []
    for key, (start, span) in enumerate(((-ramp_s, ramp_s),
                                         (0.0, float(seconds)))):
        n = int(round(rate * span))
        if n == 0:
            continue
        sizes = t.permuted(t.sizes(n), 10 + 2 * key)
        gap = t.permuted(gaps(rate, n, span), 11 + 2 * key)
        at = start
        for (prompt, out), g in zip(sizes, gap):
            at += g
            reqs.append(t.request(prompt, out, due=at))
    return reqs
