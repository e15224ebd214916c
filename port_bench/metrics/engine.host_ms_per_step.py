"""Host milliseconds per engine step in the traced window outside waits:
the window less the time the profiler saw the host blocked in CUDA
synchronizations and in waiting for arrivals, over the engine's steps
(port_bench/trace.py, serving_profile's arithmetic)."""

from port_bench import trace


def read(run):
    if run.summary is None:
        return None
    return trace.host_ms_per_step(run.summary)
