"""The four-card training cell's driver (``drivers/train_dp_loop.py``) on
the CPU: two gloo ranks at the narrowed tiny size of
``tests/test_torch_train_bench.py``, in float32, judged by the cell's own
limits.  A sound run is correct; each data-parallel fault planted in the
program is not."""

import dataclasses
import json
import time

import pytest

from h100_bench import harness

SEED = 2 ** 31 + 91


def _cell() -> harness.Cell:
    from tests.test_torch_train_bench import _tiny
    with open(harness.os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.load_cell(json.load(f), "res101_gn.train_b8x4")
    tr = dict(cell.traffic, ranks=2, batch=2, pool_pairs=8,
              objects_per_pair=3, warmup_steps=1, reference_block=2,
              calibrate_steps=2, calibrate_gap_steps=1)
    cfg = json.loads(json.dumps(dataclasses.asdict(_tiny())))
    return dataclasses.replace(cell, config={"config": cfg}, traffic=tr)


def test_sound_run_is_correct():
    from h100_bench.drivers import train_dp_loop
    out = train_dp_loop.run(_cell(), seed=SEED, seconds=0.5, trace=False,
                            t_start=time.time(), device="cpu")
    assert out.device_count == 2 and out.attempted >= 1
    assert all(c["value"] <= c["limit"] for c in out.checks.values()), \
        out.checks
    assert out.layer["stats"]["counts"]["all_reduce"][0] >= 3


@pytest.fixture(scope="module")
def faulted():
    from h100_bench.drivers import train_dp_loop
    cell = _cell()
    readings = list(train_dp_loop.calibrate(cell, [], [SEED], faults=True,
                                            device="cpu"))
    return cell, {r["kind"]: r["stats"] for r in readings}


@pytest.mark.parametrize("fault", ["dp_rank_skips_all_reduce",
                                   "dp_rank0_rows", "dp_sum_no_mean",
                                   "dp_local_uniforms", "control"])
def test_fault_is_not_correct(faulted, fault):
    cell, stats = faulted
    assert any(stats[fault][n] > lim
               for n, lim in cell.limits["limits"].items()), stats[fault]


def test_only_the_skipping_rank_differs(faulted):
    _, stats = faulted
    assert stats["dp_rank_skips_all_reduce"]["replica_mismatch"] == 1.0
    assert stats["dp_sum_no_mean"]["replica_mismatch"] == 0.0
    assert stats["dp_local_uniforms"]["sample_mismatch"] > 0.0
    assert stats["dp_sum_no_mean"]["sample_mismatch"] == 0.0
