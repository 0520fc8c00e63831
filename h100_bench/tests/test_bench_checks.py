"""The correctness check sees what it must, on the CPU at the tiny size:
a run with the timed path broken underneath comes out not correct (one
run per fault the cell can have), the control (the reference one
precision step down, in the program's place) is not correct, and a sound
run is.  Each run skips the harness's look for a card and drives the rest
of the cell's driver, judged by the cell's own limits."""

import dataclasses
import json
import os
import shutil
import time

import pytest
import torch

from h100_bench import harness

SEED = 2 ** 31 + 77


def _tiny_tree(base: str):
    from stereo_rcnn_tpu_torch.config import load_config, tiny_test_config
    big = harness._load_json(harness.ROOT, "h100_bench", "configs",
                             base + ".json")["config"]
    full = load_config(None, overrides=big)
    tiny = tiny_test_config()
    cfg = dataclasses.replace(
        tiny, compute_dtype="float32",
        backbone=dataclasses.replace(tiny.backbone, norm=full.backbone.norm,
                                     remat=full.backbone.remat),
        rcnn=dataclasses.replace(tiny.rcnn,
                                 roi_align_impl=full.rcnn.roi_align_impl,
                                 roi_align_hat=full.rcnn.roi_align_hat))
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` at the tiny size (the program in float32), with
    its own traffic driver and limits."""
    cell = harness.load_cell(_bench(), name)
    traffic = dict(cell.traffic)
    traffic.update(batch=min(traffic["batch"], 2), pool_pairs=4,
                   objects_per_pair=3, warmup_calls=1, reference_block=2)
    return dataclasses.replace(
        cell, config={"config": _tiny_tree(cell.config_name)},
        traffic=traffic)


def _run(cell, factory=None):
    import importlib
    driver = importlib.import_module("h100_bench.drivers." +
                                     cell.traffic["driver"])
    kw = {} if factory is None else {"program_factory": factory}
    out = driver.run(cell, seed=SEED, seconds=0.5, trace=False,
                     t_start=time.time(), device="cpu", **kw)
    return all(c["value"] <= c["limit"] for c in out.checks.values()), out


PIPELINE = [w["name"] for w in _bench()["workloads"]]
#: The faults of ``drivers.pipeline_loop.FAULTS``, planted in the program.
FAULTS = ["answer_altered", "half_batch_left_out", "one_detection",
          "slot_swap", "keypoint_bin"]


@pytest.mark.parametrize("name", PIPELINE)
def test_sound_run_is_correct(name):
    ok, out = _run(_tiny_cell(name))
    assert ok, out.checks


def _pipeline_fault(kind):
    from h100_bench.drivers.pipeline_loop import Program

    class Broken(Program):
        def __call__(self, left, right):
            out = super().__call__(left, right)
            det = out.det
            if kind == "answer_altered":
                pos = out.position.clone()
                pos[..., 2] *= 1.1
                return out._replace(position=pos,
                                    z_refined=out.z_refined * 1.1)
            if kind == "half_batch_left_out":
                valid = det.valid.clone()
                valid[: max(valid.shape[0] // 2, 1)] = False
                return out._replace(det=det._replace(valid=valid))
            if kind == "one_detection":
                valid = det.valid & (det.valid.cumsum(1) == 1)
                return out._replace(det=det._replace(valid=valid))
            if kind == "slot_swap":
                return type(out)(*[_swap(t) for t in out])
            width = det.box_left[..., 2] - det.box_left[..., 0]
            step = width / self.cfg.rcnn.kpt_grid
            return out._replace(det=det._replace(kpt_u=det.kpt_u + step))
    return Broken


def _swap(t):
    if isinstance(t, tuple):
        return type(t)(*[_swap(x) for x in t])
    t = t.clone()
    t[0] = t[1]
    return t


@pytest.mark.parametrize("name", PIPELINE)
@pytest.mark.parametrize("fault", FAULTS)
def test_pipeline_fault_is_not_correct(name, fault):
    cell = _tiny_cell(name)
    if fault == "slot_swap" and cell.traffic["batch"] < 2:
        pytest.skip("a batch of one has no second slot")
    ok, out = _run(cell, _pipeline_fault(fault))
    assert not ok, out.checks


@pytest.mark.parametrize("name", PIPELINE)
def test_control_is_not_correct(name):
    """The reference one precision step down in the program's place."""
    import importlib
    cell = _tiny_cell(name)
    driver = importlib.import_module("h100_bench.drivers." +
                                     cell.traffic["driver"])
    (reading,) = list(driver.calibrate(cell, [], [SEED], device="cpu"))
    assert reading["kind"] == "control"
    stats = reading["stats"]
    assert any(stats[n] > lim for n, lim in cell.limits["limits"].items()), \
        stats


@pytest.mark.cuda
@pytest.mark.parametrize("name", PIPELINE)
def test_control_on_the_card_is_not_correct(name):
    """The control at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib
    cell = harness.load_cell(_bench(), name)
    driver = importlib.import_module("h100_bench.drivers." +
                                     cell.traffic["driver"])
    for reading in driver.calibrate(cell, [], [SEED]):
        stats = reading["stats"]
        assert any(stats[n] > lim
                   for n, lim in cell.limits["limits"].items()), stats


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, as
    files only, make a cell the harness finds and runs."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    d = tmp_path / "h100_bench"
    (d / "configs" / "tiny_kron.json").write_text(json.dumps(
        {"name": "tiny_kron", "reduced": [],
         "config": _tiny_tree("res101_kron")}))
    (d / "traffic" / "tiny_b2.json").write_text(json.dumps(
        {"driver": "pipeline_loop", "batch": 2, "pool_pairs": 2,
         "objects_per_pair": 2, "warmup_calls": 1, "trace_calls": 1,
         "reference_block": 2}))
    (d / "limits" / "tiny_kron.tiny_b2.json").write_text(json.dumps(
        {"limits": {"miss": 0.5, "head": 1.0}}))
    (d / "metrics" / "calls_per_s.tiny.py").write_text(
        "def read(ctx):\n    return ctx.get('pairs_per_s')\n")
    bench["configs"].append({"name": "tiny_kron", "source": "x",
                             "file": "h100_bench/configs/tiny_kron.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_kron.tiny_b2",
                               "config": "tiny_kron", "traffic": "tiny_b2",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("tiny_kron.tiny_b2")
    bench["per_layer"].append({"name": "calls_per_s.tiny", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "pairs_per_s",
                               "workloads": ["tiny_kron.tiny_b2"]})
    cell = harness.load_cell(bench, "tiny_kron.tiny_b2", root=str(tmp_path))
    ok, out = _run(cell)
    assert ok and out.attempted >= 1
    names = [m["name"] for m in harness.metrics_of(bench, cell.name, True)]
    assert names == ["calls_per_s.tiny"]
    assert harness.read_layer_metric(names[0], out.layer,
                                     str(d)) == out.layer["pairs_per_s"]
