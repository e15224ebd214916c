"""Kernel B's share of its roofline: each layer's call's least time
(4 Hq D operations per attended key at 989 TFLOP/s, or Q, O and each
chunk's K/V rows read once at 3.35 TB/s) summed over the window's steps,
over B's device time in the trace, in percent."""

from port_bench import counts


def read(run):
    s = run.summary
    device = 0.0 if s is None else s.family_s.get("prefill_attn", 0.0)
    if device <= 0:
        return None
    bound = sum(counts.attn_bound_s(run.dims, st, "prefill")
                for st in run.steps)
    return 100.0 * bound / device
