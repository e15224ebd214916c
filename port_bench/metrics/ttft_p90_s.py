"""The 90th percentile, over every request due in the window, of the time
from its due time to its first token; a request with no token by the
close counts with its age then (host clock)."""

from port_bench import tails


def read(run):
    return tails.percentile(
        tails.first_token_waits(run.records, run.t_open, run.t_close), 90)
