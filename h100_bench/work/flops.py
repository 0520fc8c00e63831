"""FLOPs of a call of the reference, counted as ``tools/roofline.py`` of
the program counts them: ``torch.utils.flop_counter.FlopCounterMode``,
matrix products and convolutions only, two per multiply-add, forward and
(where the call runs one) backward."""

from __future__ import annotations

from typing import Callable, Tuple


def count_flops(fn: Callable, *args) -> Tuple[float, object]:
    """``(flops, result)`` of one call ``fn(*args)``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        result = fn(*args)
    return float(counter.get_total_flops()), result
