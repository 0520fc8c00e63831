"""The pipeline's time by stage: the program's spans, read on the
program's own clock and on the profiler's.

    python3 h100_bench/stages.py --workload <cell> --seed <n> \
        [--seconds 15] [--rounds 2] [--trace-calls 4]

Runs one cell's program as its driver (``drivers/pipeline_loop.py``)
does, and prints one JSON line (also written under
``chiprun_out/stages/``):

* ``first_call_s``, ``setup_spans_s``: a recorder
  (``stereo_rcnn_tpu_torch.utils.profiling.recording``) open from the
  program's construction through the warm-up gives each stage's seconds
  in the first call, and the ``setup/kernel_*`` spans' seconds;
* ``windows``: measured windows of ``--seconds`` each, the recorder
  closed and open in turns (off, on, on, off, ...), with their seconds
  per call; ``host``: each stage's host ms, self ms and count per call
  over the open windows; ``solve_host_share``: host time inside
  ``infer/solve`` and ``infer/align`` over the open windows' wall time
  (%);
* ``device_by_span``: a ``torch.profiler`` window of ``--trace-calls``
  calls after the others, reduced by :func:`by_span` (kernels, device
  ms, idle ms, syncs and lag per call for each stage and
  ``(outside)``); ``launches_per_call`` (as ``launches_per_call.*``
  count them), ``solve_launches_per_call`` (those launched inside
  ``infer/solve`` and ``infer/align``) and ``unlinked_kernels`` (kernels
  whose launch the trace does not hold);
* ``span_ns``: the host's cost of one span, off and under a recorder.

The benchmark's run (``run.py``) does not run this; it needs a program
with the spans.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import re
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

#: The program's stage spans (``utils/profiling.py``).
STAGE = re.compile(r"^(infer|train|setup)/")
OUTSIDE = "(outside)"
SOLVE = ("infer/solve", "infer/align")
#: Host runtime calls: launches carry the correlation id of their kernel.
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
#: Host runtime calls that wait for the card.
_SYNC = re.compile(r"^cu(da)?\w*Synchronize|^cudaMemcpy$|^cuMemcpy[DH]to")


@dataclasses.dataclass
class Window:
    """What :func:`by_span` reads of a profiler window (times in us)."""

    w0: float
    w1: float
    units: int                                # calls in the window
    ranges: List[Tuple[float, float, str]]    # the program's stage spans
    launches: Dict[int, float]                # correlation id -> call start
    kernels: List[Tuple[float, float, int]]   # (start, end, correlation id)
    busy: List[Tuple[float, float]]           # merged device activity
    syncs: List[Tuple[float, str]]            # sync calls: start, ATen op


def _segments(ranges):
    """Elementary intervals of the ranges' edges: their starts, and for
    each the ranges covering it, innermost (latest start) last."""
    edges = sorted({x for s, e, _ in ranges for x in (s, e)})
    starts, covers = [], []
    for a, b in zip(edges, edges[1:]):
        mid = 0.5 * (a + b)
        cover = sorted((i for i, (s, e, _) in enumerate(ranges)
                        if s <= mid < e), key=lambda i: (ranges[i][0],
                                                         -ranges[i][1]))
        starts.append(a)
        covers.append(cover)
    if edges:
        starts.append(edges[-1])
        covers.append([])
    return starts, covers


def by_span(win: Window) -> Dict[str, Dict[str, float]]:
    """Per stage span name and ``(outside)``, per call: ``kernels`` (each
    kernel goes to the innermost span holding the runtime call that
    launched it; a kernel whose launch is in no span, or not in the
    trace, goes outside), ``device_ms`` (their device time), ``idle_ms``
    (each idle gap of the window goes to the innermost span at its
    middle), ``syncs`` (synchronising runtime calls, by their start;
    ``sync_ops`` splits them by the innermost ATen operator around
    each) and
    ``count``; and ``lag_ms``, the mean over the span's instances of the
    end of the last kernel launched inside it (nested spans included)
    less the span's end, 0 where the card had finished.  The ``kernels``
    rows sum to the window's kernels per call."""
    starts, covers = _segments(win.ranges)

    def cover(t):
        i = bisect.bisect_right(starts, t) - 1
        return covers[i] if 0 <= i < len(covers) else []

    def owner(t):
        c = cover(t)
        return win.ranges[c[-1]][2] if c else OUTSIDE

    rows: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(
        ("count", "kernels", "device_ms", "idle_ms", "syncs", "lag_ms"),
        0.0))
    last_end = [None] * len(win.ranges)
    for s, e, corr in win.kernels:
        t = win.launches.get(corr)
        c = cover(t) if t is not None else []
        row = rows[win.ranges[c[-1]][2] if c else OUTSIDE]
        row["kernels"] += 1
        row["device_ms"] += (e - s) * 1e-3
        for i in c:
            if last_end[i] is None or e > last_end[i]:
                last_end[i] = e
    edges = [win.w0] + [x for iv in win.busy for x in iv] + [win.w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            rows[owner(0.5 * (a + b))]["idle_ms"] += (b - a) * 1e-3
    by_op: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(
        float))
    for t, op in win.syncs:
        rows[owner(t)]["syncs"] += 1
        by_op[owner(t)][op] += 1
    lags = defaultdict(list)
    for (s, e, name), end in zip(win.ranges, last_end):
        lags[name].append(max(end - e, 0.0) * 1e-3 if end is not None
                          else 0.0)
    for name, vals in lags.items():
        rows[name]["count"] += len(vals)
        rows[name]["lag_ms"] = sum(vals) / len(vals)
    n = max(win.units, 1)
    for name, row in rows.items():
        for k in ("count", "kernels", "device_ms", "idle_ms", "syncs"):
            row[k] /= n
        row["sync_ops"] = {op: c / n for op, c in by_op[name].items()}
    return dict(rows)


def profiled(fn: Callable[[int], None], units: int) -> Window:
    """Run ``fn(0) .. fn(units - 1)`` under ``torch.profiler``, as
    ``trace.traced`` does, and keep what :func:`by_span` reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from h100_bench.trace import _COPIES, WINDOW, _innermost, _union
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
    host_ranges = {e.name for e in events if e.device_type != cuda and
                   "/" in e.name and not e.name.startswith(("aten::",
                                                            "cuda"))}
    ranges, launches, kernels, dev, syncs, ops = [], {}, [], [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            annotation = (getattr(e, "is_user_annotation", False) or
                          e.name in host_ranges)
            if t > w0 and s < w1 and not annotation:
                dev.append((max(s, w0), min(t, w1)))
                if not _COPIES.search(e.name):
                    kernels.append((max(s, w0), min(t, w1), e.id))
        elif _RUNTIME.search(e.name):
            launches[e.id] = s
            if w0 <= s <= w1 and _SYNC.search(e.name):
                syncs.append(s)
        elif STAGE.search(e.name) and w0 <= s <= w1:
            ranges.append((s, t, e.name))
        elif e.name.startswith("aten::") and w0 <= s <= w1:
            ops.append((s, t, e.name))
    ops.sort()
    starts = [s for s, _, _ in ops]
    return Window(w0=w0, w1=w1, units=units, ranges=ranges,
                  launches=launches, kernels=kernels,
                  busy=[tuple(iv) for iv in _union(dev)],
                  syncs=[(t, _innermost(ops, starts, t)) for t in syncs])


def span_cost_ns(n: int = 100_000) -> Dict[str, float]:
    """ns per ``with span(...)`` on this host: off, and under a recorder
    (the spans are kept, then dropped), the garbage collector held off
    as in a measured window."""
    import gc
    import time

    from stereo_rcnn_tpu_torch.utils.profiling import recording, span

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("infer/solve"):
                pass
        return (time.perf_counter_ns() - t0) / n

    gc.collect()
    gc.disable()
    off = loop()
    with recording():
        on = loop()
    gc.enable()
    return {"off": off, "recorder": on}


def _host_table(recs, window_s: float) -> dict:
    """Each stage's host numbers per call over the recorders ``recs``,
    and the solve and alignment's share of their windows' wall time."""
    calls = sum(r.calls for r in recs)
    table: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for rec in recs:
        for name, row in rec.per_call().items():
            for key, v in row.items():
                table[name][key] += v * rec.calls / calls
    solve_ms = sum(table[k]["host_ms"] for k in SOLVE if k in table)
    return {"host": {k: dict(v) for k, v in table.items()},
            "solve_host_share": 100.0 * solve_ms * calls / (1e3 * window_s)}


def run(cell_name: str, seed: int, seconds: float, rounds: int,
        trace_calls: int) -> dict:
    import gc
    import time

    import torch

    from h100_bench import harness
    from h100_bench.compare.pipeline import FIELDS, answer_fields
    from h100_bench.drivers.pipeline_loop import Program, frames, setup
    from stereo_rcnn_tpu_torch.utils.profiling import recording

    bench = harness._load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.load_cell(bench, cell_name)
    harness.set_cache_dirs()
    problem = harness.check_cards(cell.chips)
    if problem:
        raise SystemExit(problem)
    torch.set_num_threads(1)
    tr = cell.traffic
    batch, pool_n = tr["batch"], tr["pool_pairs"]
    dev = torch.device("cuda", 0)

    with recording() as first:
        _, pool, sd, _, _ = setup(cell, seed, dev)
        program = Program(cell, sd, tuple(pool.calib), dev)
        del sd
        left_h = torch.from_numpy(pool.left).pin_memory()
        right_h = torch.from_numpy(pool.right).pin_memory()

        def call(k: int):
            i = frames(k, batch, pool_n)[0]
            left = left_h[i:i + batch].to(dev, non_blocking=True)
            right = right_h[i:i + batch].to(dev, non_blocking=True)
            out = answer_fields(program(left, right))
            host = [t.to("cpu", non_blocking=True) for t in out]
            torch.cuda.current_stream(dev).synchronize()
            return {f: t.numpy() for f, t in zip(FIELDS, host)}

        for k in range(tr["warmup_calls"]):
            call(k)
    setup_spans: Dict[str, float] = defaultdict(float)
    for s in first.spans:
        if s.name.startswith("setup/"):
            setup_spans[s.name] += (s.t1_ns - s.t0_ns) * 1e-9
    first_call = {k: v["host_ms"] * 1e-3
                  for k, v in first.per_call(1).items()}

    k = tr["warmup_calls"]
    windows, recs, on_s = [], [], 0.0
    for r in range(2 * rounds):
        on = r % 4 in (1, 2)
        gc.collect()
        gc.disable()
        with (recording() if on else contextlib.nullcontext()) as rec:
            t0 = time.perf_counter()
            calls = 0
            while time.perf_counter() < t0 + seconds:
                call(k)
                k += 1
                calls += 1
            window = time.perf_counter() - t0
        gc.enable()
        windows.append({"recorder": on, "calls": calls,
                        "call_s": window / calls})
        if on:
            recs.append(rec)
            on_s += window
    host = _host_table(recs, on_s)

    win = profiled(lambda i: call(k + i), trace_calls)
    device = by_span(win)
    solve_launches = sum(device.get(n, {}).get("kernels", 0.0)
                         for n in SOLVE)
    return {
        "workload": cell_name, "seed": seed,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "first_call_s": first_call, "setup_spans_s": dict(setup_spans),
        "windows": windows, **host,
        "device_by_span": device,
        "traced_call_s": (win.w1 - win.w0) * 1e-6 / win.units,
        "launches_per_call": len(win.kernels) / win.units,
        "solve_launches_per_call": solve_launches,
        "unlinked_kernels": sum(1 for *_, c in win.kernels
                                if c not in win.launches),
        "span_ns": span_cost_ns(),
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--trace-calls", type=int, default=4)
    args = p.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, args.rounds,
              args.trace_calls)
    line = json.dumps(out)
    from h100_bench.harness import ROOT
    path = os.path.join(ROOT, "chiprun_out", "stages",
                        f"{args.workload}.{args.seed}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
