"""The training step's share of the card's bf16 peak (%): the reference's
forward and backward FLOPs per pair (remat's recompute not counted) times
the window's pairs per second."""
from h100_bench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, "pairs_per_s")
