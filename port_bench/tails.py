"""Rates and tails of a window, from the clients' own stamps.

A tail is the tail of every request: a request still waiting for its
first token when the window closes counts with its age at the close, and
one still waiting for its next token adds its open gap.  A rate is all
the work of the window over all its time.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear interpolation), or None
    for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def token_gaps(records: Iterable, t_open: float, t_close: float
               ) -> List[float]:
    """Every gap between two consecutive output tokens of a request whose
    later token arrived in the window, and each running request's open
    gap at the close (from its last token, if it has one)."""
    gaps: List[float] = []
    for rec in records:
        s = [t for t in rec.stamps if t < t_close]
        gaps += [b - a for a, b in zip(s, s[1:]) if b >= t_open]
        running = rec.finished_at is None or rec.finished_at >= t_close
        if s and running:
            gaps.append(t_close - s[-1])
    return gaps


def first_token_waits(records: Iterable, t_open: float, t_close: float
                      ) -> List[float]:
    """For every request due in the window, the time from its due time to
    its first token, or its age at the close where none came."""
    waits = []
    for rec in records:
        if not t_open <= rec.due < t_close:
            continue
        if rec.stamps and rec.stamps[0] < t_close:
            waits.append(rec.stamps[0] - rec.due)
        else:
            waits.append(t_close - rec.due)
    return waits


def unanswered(records: Iterable, t_open: float, t_close: float) -> int:
    """Requests due in the window with no token by its close."""
    return sum(1 for r in records if t_open <= r.due < t_close
               and not (r.stamps and r.stamps[0] < t_close))


def window_tokens(steps) -> int:
    """Prompt-chunk tokens and output tokens of the steps dispatched in
    the window."""
    return sum(s.tokens for s in steps)
