"""The four-card training step's share of the four cards' bf16 peak (%):
the reference's forward and backward FLOPs per pair (as ``mfu.train``)
times the window's pairs per second over every card."""
from h100_bench.readers import mfu_percent


def read(ctx):
    share = mfu_percent(ctx, "pairs_per_s")
    return None if share is None else share / ctx["cards"]
