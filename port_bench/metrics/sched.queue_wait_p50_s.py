"""The median wait in the scheduler's queue of the requests due in the
window: the engine's own scheduling delay (its sequence state's first
RUNNING stamp less the due time), or the age at the close of one never
scheduled (program counter)."""

from port_bench import tails


def read(run):
    waits = [r.scheduling_delay if r.scheduling_delay is not None
             else run.t_close - r.due
             for r in run.records if run.t_open <= r.due < run.t_close]
    return tails.percentile(waits, 50)
