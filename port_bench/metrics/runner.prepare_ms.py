"""Preparing a step's inputs (the host arrays and their one staged copy
to the device): the ``vattn.prepare`` spans that end in the window, in
milliseconds per ``vattn.step`` span that ends in it, from the program's
span records (program span)."""

SPAN = "vattn.prepare"


def read(run):
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    spans = list(getattr(MetricsStore.get_instance(), "spans", ()))
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    ended = [s for s in spans if lo <= s.end_ns < hi]
    steps = sum(1 for s in ended if s.name == "vattn.step")
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in ended
               if s.name == SPAN) / steps / 1e6
