"""step_mfu (%): the whole step's share of the card's peak: 6 nnz K
operations per iteration (counters.py) over the traced window's seconds
per iteration, against 989 TFLOP/s."""

from hpfbench import counters


def read(ctx: dict):
    per_iter = ctx["trace"].window_s / ctx["iterations"]
    flops = counters.sweep_flops(ctx["nnz"], ctx["k"])
    return 100.0 * flops / per_iter / counters.PEAK_FLOPS
