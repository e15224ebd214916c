"""Uniform lengths on ``[lo, hi]``: ``{"uniform": [lo, hi]}``."""

from port_bench.generator import strata


def sizes(args, n: int) -> list:
    """``n`` equal-probability strata, each its midpoint."""
    lo, hi = args
    return strata(lo, hi, n)
