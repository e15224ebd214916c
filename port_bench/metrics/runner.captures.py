"""Step graphs captured in the window: the sum of the ``captured`` count
of the program's ``vattn.launch`` spans that end in the window, from the
program's span records (program counter).  The warm-up meets every step
signature, so this reads 0; a capture inside the window runs the step
eagerly and then captures it, and the steps behind it wait."""

SPAN = "vattn.launch"


def read(run):
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    spans = list(getattr(MetricsStore.get_instance(), "spans", ()))
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    launches = [s for s in spans if s.name == SPAN and lo <= s.end_ns < hi]
    if not launches:
        return None
    return sum(s.counts.get("captured", 0) for s in launches)
