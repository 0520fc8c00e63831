"""A traced window: ``torch.profiler`` over a fixed number of calls, kept
in memory and reduced to the numbers the per-layer metrics read.

Device activity is every event the profiler puts on the card (kernels,
copies, fills).  ``busy_s`` is the union of their intervals inside the
window, the window being the host range ``bench/window`` around the
calls.  An idle gap is an interval of the window with nothing on the
card; it is labelled by the innermost host operation running at its
middle (an ATen operator or a range of the program), which says what
the card waited for.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench/window"
_COPIES = re.compile(r"^(Memcpy|Memset|memcpy|memset)")


@dataclasses.dataclass
class Trace:
    """What a traced window saw (times in seconds)."""

    window_s: float
    busy_s: float
    units: int                       # calls or steps in the window
    kernels: List[Tuple[str, float]]  # (name, duration) of each kernel
    device_by_name: Dict[str, float]
    idle_by_host_op: Dict[str, float]

    def kernel_times(self, pattern: str) -> List[float]:
        named = re.compile(pattern)
        return [d for n, d in self.kernels if named.search(n)]

    def breakdown(self, top: int = 10) -> dict:
        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.device_by_name),
                "idle_gaps": best(self.idle_by_host_op)}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(ops, starts, t):
    """The host op covering ``t`` that started last (the innermost)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = ops[j]
        if e >= t and name != WINDOW:
            return name
    return "(no host op)"


def traced(fn: Callable[[int], None], units: int) -> Trace:
    """Run ``fn(0) .. fn(units - 1)`` under the profiler and reduce it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(units):
                fn(i)
            torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, ops = [], []
    host_ranges = {e.name for e in events if e.device_type != cuda and
                   "/" in e.name and not e.name.startswith(("aten::",
                                                            "cuda"))}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # A profiler range appears on the card's timeline too, as an
            # annotation: it is no device work.
            annotation = (getattr(e, "is_user_annotation", False) or
                          e.name in host_ranges)
            if t > w0 and s < w1 and not annotation:
                dev.append((max(s, w0), min(t, w1), e.name))
        elif w0 <= s <= w1 and (e.name.startswith("aten::") or
                                e.name in host_ranges):
            ops.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in dev])
    by_name = defaultdict(float)
    kernels = []
    for s, t, name in dev:
        by_name[name[:160]] += (t - s) * 1e-6
        if not _COPIES.search(name):
            kernels.append((name, (t - s) * 1e-6))
    ops.sort()
    starts = [s for s, _, _ in ops]
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[::2], edges[1::2]):
        if t > s:
            idle[_innermost(ops, starts, 0.5 * (s + t))[:160]] += (
                (t - s) * 1e-6)
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(t - s for s, t in busy) * 1e-6, units=units,
                 kernels=kernels, device_by_name=dict(by_name),
                 idle_by_host_op=dict(idle))
