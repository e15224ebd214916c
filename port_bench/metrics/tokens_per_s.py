"""Every prompt-chunk token and output token of the steps the engine
dispatched in the window, over the window's seconds (host clock; the
window is bounded by two synchronizations, so each of its steps ran in
it)."""

from port_bench import tails


def read(run):
    return tails.window_tokens(run.steps) / run.window_s
