"""Host milliseconds of the engine's own step: the mean, over the
program's ``vattn.step`` spans that end in the window, of each span's
duration less its ``vattn.resolve_wait`` spans (the host waiting for a
step's samples to land), from the program's span records (program
span)."""


def read(run):
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    spans = list(getattr(MetricsStore.get_instance(), "spans", ()))
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    steps = [s for s in spans
             if s.name == "vattn.step" and lo <= s.end_ns < hi]
    if not steps:
        return None
    waits = {}
    for s in spans:
        if s.name == "vattn.resolve_wait":
            waits[s.step] = waits.get(s.step, 0) + s.end_ns - s.start_ns
    busy = [s.end_ns - s.start_ns - waits.get(s.step, 0) for s in steps]
    return sum(busy) / len(busy) / 1e6
