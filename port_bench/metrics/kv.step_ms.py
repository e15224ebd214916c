"""The cache engine's step (the arena's allocator, its relocation plan),
mean milliseconds per engine step in the window, from the program's own
host timer (MetricsStore's ``kv_cache_step``)."""


def read(run):
    if not run.kv_step_s:
        return None
    return sum(run.kv_step_s) / len(run.kv_step_s) * 1e3
