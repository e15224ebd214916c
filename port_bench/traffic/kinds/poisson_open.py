"""Open loop of independent users arriving at ``rate`` requests a second,
Poisson: the gaps are the exponential's quantiles (``generator.exp_gaps``).
``ramp_s`` seconds of arrivals come before the window, so that it opens
loaded.
"""

from port_bench.generator import exp_gaps, open_arrivals

CLOSED = False


def arrivals(t, seconds: float) -> list:
    """The ramp's arrivals (due before 0) and the window's (due in
    [0, seconds)), each a fixed set in a fixed order."""
    return open_arrivals(t, seconds, exp_gaps)
