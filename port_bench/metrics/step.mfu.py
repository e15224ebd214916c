"""The window's share of the card's bf16 peak: the operations of every
step dispatched in it, counted from its shapes (projections and MLP of
every layer, the lm head on sampled rows, attention at 4 Hq D per
attended key and layer, Mistral's window applied), over the window's
seconds times 989 TFLOP/s, in percent (host clock)."""

from port_bench import counts, peaks


def read(run):
    flops = sum(counts.step_flops(run.dims, s) for s in run.steps)
    if not flops:
        return None
    return 100.0 * flops / (run.window_s * peaks.BF16_FLOPS)
