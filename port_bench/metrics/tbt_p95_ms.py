"""The 95th percentile of every gap between consecutive output tokens of
every request, as the clients stamped them, whose later token came in
the window; a request still running at the close adds its open gap
(host clock)."""

from port_bench import tails


def read(run):
    gaps = tails.token_gaps(run.records, run.t_open, run.t_close)
    value = tails.percentile(gaps, 95)
    return None if value is None else value * 1e3
