"""Rank 0's device time in the gradient all-reduce per step, over the
step's time (%): the kernels launched inside the program's span
``train/all_reduce/collective`` (NCCL's, their wait for a late rank
included), over the same profiled window's seconds per step.  Both come
from one window: the profiler slows every rank's issue, and with it the
waits for a late rank."""


def read(ctx):
    per_step = ctx.get("collective_s")
    step_s = ctx.get("traced_step_s")
    if not per_step or not step_s:
        return None
    return 100.0 * sum(per_step) / len(per_step) / step_s
