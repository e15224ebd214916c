"""The 90th percentile of the program's ``vattn.request.prefill`` spans
that end in the window: a request's first scheduling to the dispatch of
its last prompt chunk, in seconds, from the program's span records
(program span)."""

from port_bench import tails


def read(run):
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    spans = list(getattr(MetricsStore.get_instance(), "spans", ()))
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    return tails.percentile(
        [(s.end_ns - s.start_ns) / 1e9 for s in spans
         if s.name == "vattn.request.prefill" and lo <= s.end_ns < hi], 90)
