"""The port's stage-breakdown and roofline tools on the CPU
(``tools/perf_breakdown.py``, ``tools/roofline.py``).

The work counter is held to hand counts: the FLOPs of one ``Conv2d`` and
one ``Linear`` are 2 x their multiply-adds, from the shapes; the bytes of
one elementwise op are its inputs plus its output (a broadcast input's
distinct elements); a view moves 0 bytes.  Over the six nested prefixes
at the tiny config, FLOPs and bytes never decrease.  Both tools run end
to end with ``--device cpu`` and then print no time and no share: a CPU
time is never printed under a device metric.
"""

import re

import torch

from stereo_rcnn_tpu_torch.tools import perf_breakdown, roofline
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_flops_of_conv_and_linear_are_twice_the_macs():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 16, 20)
    flops, _ = roofline.count(conv, x)
    assert flops == 2 * (2 * 8 * 16 * 20) * (3 * 3 * 3)
    lin = torch.nn.Linear(32, 64)
    flops, n_bytes = roofline.count(lin, torch.randn(5, 32))
    assert flops == 2 * 5 * 32 * 64
    assert n_bytes > 0


def test_bytes_of_elementwise_ops_and_views():
    a, b = torch.randn(1000), torch.randn(1000)
    assert roofline.count(torch.add, a, b) == (0.0, 3 * 1000 * 4)
    # A broadcast operand is read once per distinct element.
    c = torch.randn(1)
    assert roofline.count(torch.mul, a, c) == (0.0, (1000 + 1 + 1000) * 4)
    half = torch.randn(64, 32, dtype=torch.bfloat16)
    assert roofline.count(torch.neg, half) == (0.0, 2 * 64 * 32 * 2)
    for view in (lambda x: x.view(10, 100), lambda x: x[3:70],
                 lambda x: x.t() if x.dim() == 2 else x.unsqueeze(0)):
        assert roofline.count(view, a) == (0.0, 0.0)
    # An in-place op reads and writes its operand.
    assert roofline.count(lambda x: x.add_(1.0), a.clone()) == \
        (0.0, 2 * 1000 * 4)


def test_roofline_counts_grow_over_the_prefixes_and_print_no_time(capsys):
    rows = roofline.main(["--tiny", "--batch", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["prefix"] for r in rows] == list(perf_breakdown.PREFIX_NAMES)
    for prev, row in zip(rows, rows[1:]):
        assert row["gflop"] >= prev["gflop"], (prev, row)
        assert row["gb"] >= prev["gb"], (prev, row)
    assert rows[0]["gflop"] > 0 and rows[0]["gb"] > 0
    for row in rows:
        assert row["ms"] is None and row["util"] is None
        assert row["mfu"] is None
    table = [line for line in out.splitlines()
             if line.startswith(perf_breakdown.PREFIX_NAMES)]
    assert len(table) == 6
    for line in table:
        assert line.count("not measured") == 3, line
    assert "pairs/s" not in out


def test_perf_breakdown_runs_and_prints_no_time(capsys):
    rows = perf_breakdown.main(["--tiny", "--batch", "1", "--impl", "xla",
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["prefix"] for r in rows] == list(perf_breakdown.PREFIX_NAMES)
    assert all(r["ms"] is None for r in rows)
    assert "pairs/s" not in out
    assert not re.search(r"\d ms/batch", out)
    assert out.count("ms/batch not measured") == 6
