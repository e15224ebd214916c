"""Kernel C's share of its roofline (both its passes): each layer's
call's least time (each sequence's query and output, and its K/V rows,
the last ``window`` of them for Mistral, read once at 3.35 TB/s, or 4 Hq
D operations per key at 989 TFLOP/s) summed over the window's steps,
over C's device time in the trace, in percent."""

from port_bench import counts


def read(run):
    s = run.summary
    device = 0.0 if s is None else s.family_s.get("decode_attn", 0.0)
    if device <= 0:
        return None
    bound = sum(counts.attn_bound_s(run.dims, st, "decode")
                for st in run.steps)
    return 100.0 * bound / device
