"""The whole pipeline's share of the card's bf16 peak, offline (%)."""
from h100_bench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, "pairs_per_s")
