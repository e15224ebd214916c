"""The projections' and lm head's share of their roofline: each call's
least time (the larger of its operations at 989 TFLOP/s and its weight,
input and output bytes at 3.35 TB/s) summed over the window's steps, over
the GEMM kernels' device time in the trace, in percent."""

from port_bench import counts


def read(run):
    s = run.summary
    device = 0.0 if s is None else s.family_s.get("matmul", 0.0)
    if device <= 0:
        return None
    bound = sum(counts.gemm_bound_s(run.dims, st) for st in run.steps)
    return 100.0 * bound / device
