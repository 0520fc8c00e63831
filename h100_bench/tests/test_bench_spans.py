"""``stages.by_span``: the per-stage reduction of a profiler window, on
synthetic host ranges, runtime launches and kernel intervals (us)."""

import os
import subprocess
import sys

import pytest

from h100_bench import harness
from h100_bench.stages import OUTSIDE, Window, by_span

# One call: the pipeline 0..100 holding backbone 10..40 and solve 50..90.
RANGES = [(0.0, 100.0, "infer/pipeline"), (10.0, 40.0, "infer/backbone"),
          (50.0, 90.0, "infer/solve")]


def _window(**kw):
    base = dict(w0=0.0, w1=200.0, units=1, ranges=RANGES, launches={},
                kernels=[], busy=[], syncs=[])
    base.update(kw)
    return Window(**base)


def test_a_kernel_goes_to_the_span_that_launched_it():
    """Launched inside the backbone, run during the solve: the backbone's.
    Launched between the two stages: the pipeline's own."""
    win = _window(launches={1: 20.0, 2: 45.0},
                  kernels=[(60.0, 70.0, 1), (80.0, 85.0, 2)],
                  busy=[(60.0, 70.0), (80.0, 85.0)])
    rows = by_span(win)
    assert rows["infer/backbone"]["kernels"] == 1
    assert rows["infer/backbone"]["device_ms"] == pytest.approx(0.010)
    assert rows["infer/pipeline"]["kernels"] == 1
    assert rows["infer/solve"]["kernels"] == 0


def test_an_idle_gap_goes_to_the_innermost_span_at_its_middle():
    """Busy 0..55 and 95..110: the gap 55..95 (middle 75) is the solve's,
    the gap 110..200 (middle 155) outside every span."""
    rows = by_span(_window(busy=[(0.0, 55.0), (95.0, 110.0)]))
    assert rows["infer/solve"]["idle_ms"] == pytest.approx(0.040)
    assert rows[OUTSIDE]["idle_ms"] == pytest.approx(0.090)
    assert rows["infer/backbone"]["idle_ms"] == 0
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(0.130)


@pytest.mark.parametrize("units", [1, 2])
def test_syncs_lag_and_counts_per_call(units):
    """The backbone's last kernel ends at 65, 25 us after the backbone;
    the solve's ends at 85, before the solve ends (lag 0); the
    pipeline's last (its children's included) at 85, before 100."""
    win = _window(units=units, launches={1: 15.0, 2: 30.0, 3: 60.0},
                  kernels=[(20.0, 30.0, 1), (35.0, 65.0, 2),
                           (70.0, 85.0, 3)],
                  syncs=[(55.0, "aten::_local_scalar_dense"),
                         (150.0, "(no host op)")])
    rows = by_span(win)
    assert rows["infer/backbone"]["lag_ms"] == pytest.approx(0.025)
    assert rows["infer/solve"]["lag_ms"] == 0
    assert rows["infer/pipeline"]["lag_ms"] == 0
    assert rows["infer/solve"]["syncs"] == 1 / units
    assert rows["infer/solve"]["sync_ops"] == {
        "aten::_local_scalar_dense": 1 / units}
    assert rows[OUTSIDE]["syncs"] == 1 / units
    assert rows["infer/backbone"]["kernels"] == 2 / units
    assert rows["infer/solve"]["count"] == 1 / units


def test_rows_sum_to_the_window_kernels():
    """Kernels launched outside every span, or whose launch the trace
    lacks, go to ``(outside)``; the rows sum to the window's kernels per
    call.  A second call's spans of the same names add up."""
    second = [(s + 100.0, e + 100.0, n) for s, e, n in RANGES]
    launches = {i: float(t) for i, t in enumerate(range(0, 200, 7))}
    kernels = [(t + 1.0, t + 2.0, i) for i, t in launches.items()]
    kernels.append((5.0, 6.0, 999))                     # launch not traced
    win = _window(units=2, ranges=RANGES + second, launches=launches,
                  kernels=kernels, w1=210.0)
    rows = by_span(win)
    assert sum(r["kernels"] for r in rows.values()) == len(kernels) / 2
    assert rows[OUTSIDE]["kernels"] > 0
    assert rows["infer/solve"]["count"] == 1
    assert set(rows) == {OUTSIDE, "infer/pipeline", "infer/backbone",
                         "infer/solve"}


def test_the_stage_tool_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r})\n"
            "import h100_bench.stages\n"
            "import stereo_rcnn_tpu_torch.utils.profiling\n"
            "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, cwd=harness.ROOT)
    assert not set(out.stdout.split()) & set(harness.FORBIDDEN)
