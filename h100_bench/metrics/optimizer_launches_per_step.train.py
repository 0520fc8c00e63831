"""Kernels launched inside the ``train/optimizer`` span per training step,
each kernel given to the innermost span around the call that launched it
(``stages.by_span``)."""


def read(ctx):
    row = (ctx.get("by_span") or {}).get("train/optimizer")
    return None if row is None else row["kernels"]
