"""The share of the traced window in which no operation ran on the
device: 1 - (the union of the device's operation intervals / the
window), in percent (device trace)."""

from port_bench import trace


def read(run):
    return trace.idle_share(run.summary)
