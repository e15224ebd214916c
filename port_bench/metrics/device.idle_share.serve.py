"""As ``device.idle_share.tput``, in the cells served at arrival times,
where it moves the tail of the first token's wait (device trace)."""

from port_bench import trace


def read(run):
    return trace.idle_share(run.summary)
