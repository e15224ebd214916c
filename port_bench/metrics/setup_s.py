"""Seconds from the process's start until the window opens: imports, the
kernels' libraries (built on a checkout's first run), the engine and its
arena, the seed's weights, the warm-up that captures each step signature,
and the cell's ramp (host clock)."""


def read(run):
    return run.setup_s
