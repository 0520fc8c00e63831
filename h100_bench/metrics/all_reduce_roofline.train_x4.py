"""The gradient all-reduce's share of its bound (%): the bus bytes of the
buffer the program's counter saw (``work.collective_bytes``) at NVLink's
rate, over the all-reduce's time.  Per traced step the time is the
shortest over the ranks (the rank that arrived last, which waited on no
one); the median over the steps is taken."""

import statistics

from h100_bench.work.collective_bytes import all_reduce_bound_s


def read(ctx):
    by_rank = ctx.get("collective_s_by_rank")
    n_bytes = ctx.get("gradient_bytes")
    if not by_rank or not n_bytes or not all(by_rank):
        return None
    fastest = [min(step) for step in zip(*by_rank)]
    if min(fastest) <= 0.0:
        return None
    return 100.0 * all_reduce_bound_s(len(by_rank), n_bytes) / \
        statistics.median(fastest)
