"""The port's stage spans (``utils/profiling.py``) on the CPU.

Off, a span is a flag check; under a recorder it keeps name, parent,
call and times; under ``torch.profiler`` it is a host range.  One tiny
frozen-BN pipeline (float32, the fused RoIAlign's plain version, default
initialisation, 2 Gauss-Newton iterations so that the profiler's
post-processing stays short) shows the stages where the work happens,
with outputs the recorder does not change.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.inference import make_full_pipeline
from stereo_rcnn_tpu_torch.models.detector import build_model
from stereo_rcnn_tpu_torch.utils import profiling
from stereo_rcnn_tpu_torch.utils.profiling import recording, span
from tests.torch_threads import one_torch_thread  # noqa: F401

STAGES = ["infer/backbone", "infer/rpn", "infer/roi_align", "infer/heads",
          "infer/post", "infer/keypoints", "infer/solve", "infer/align",
          "infer/solve"]


def test_profiler_flag_is_a_module_bool():
    """``span`` reads this private attribute instead of entering
    ``record_function``; it is set only while a profiler runs."""
    autograd_profiler = torch.autograd.profiler
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_off_span_enters_nothing_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    with span("infer/pipeline", new_call=True):
        with span("infer/solve"):
            pass
    assert entered == []
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.calls == 0


def test_nesting_parent_call_and_self_time():
    """On a clock that steps 1 ms per reading."""
    ticks = iter(range(0, 10 ** 9, 10 ** 6))
    with recording(clock=lambda: next(ticks)) as rec:
        with span("setup/kernel_load"):          # 0..1, call 0
            pass
        with span("a", new_call=True):           # 2..7
            with span("b"):                      # 3..4
                pass
            with span("b"):                      # 5..6
                pass
        with span("a", new_call=True):           # 8..11
            with span("c"):                      # 9..10
                with pytest.raises(RuntimeError, match="already open"):
                    with recording():
                        pass
    ms = 10 ** 6
    assert rec.calls == 2
    assert rec.spans == [
        ("setup/kernel_load", None, 0, 0, 1 * ms),
        ("b", "a", 1, 3 * ms, 4 * ms), ("b", "a", 1, 5 * ms, 6 * ms),
        ("a", None, 1, 2 * ms, 7 * ms),
        ("c", "a", 2, 9 * ms, 10 * ms), ("a", None, 2, 8 * ms, 11 * ms)]
    assert rec.per_call() == {
        "a": {"count": 1.0, "host_ms": 4.0, "self_ms": 2.5},
        "b": {"count": 1.0, "host_ms": 1.0, "self_ms": 1.0},
        "c": {"count": 0.5, "host_ms": 0.5, "self_ms": 0.5}}
    assert rec.per_call(1)["a"] == {"count": 1.0, "host_ms": 5.0,
                                    "self_ms": 3.0}
    assert rec.per_call(0) == {"setup/kernel_load": {
        "count": 1.0, "host_ms": 1.0, "self_ms": 1.0}}
    with span("a"):
        pass
    assert len(rec.spans) == 6


@pytest.fixture(scope="module")
def tiny():
    base = tiny_test_config()
    cfg = dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"),
        solver=dataclasses.replace(base.solver, gn_iters=2))
    il, ir, calib = synthetic_images(cfg, 1, seed=7, n_objects=2)
    pipe = make_full_pipeline(cfg, calib)
    model = build_model(cfg).eval()
    images = (torch.from_numpy(il), torch.from_numpy(ir))
    return lambda: pipe(model, *images)


def _leaves(out):
    return [np.asarray(x) for x in (*out.det, out.position, out.ry,
                                    out.z_refined, out.residual)]


def test_recorded_call_has_every_stage_and_the_same_outputs(tiny):
    plain = _leaves(tiny())
    with recording() as rec:
        out = _leaves(tiny())
    assert rec.calls == 1
    top = [s for s in rec.spans if s.parent is None]
    assert [(s.name, s.call) for s in top] == [("infer/pipeline", 1)]
    under = sorted((s for s in rec.spans if s.parent == "infer/pipeline"),
                   key=lambda s: s.t0_ns)
    assert [s.name for s in under] == STAGES
    assert len(rec.spans) == 1 + len(STAGES)
    assert all(top[0].t0_ns <= s.t0_ns <= s.t1_ns <= top[0].t1_ns
               for s in under)
    table = rec.per_call()
    assert table["infer/solve"]["count"] == 2
    assert 0 <= table["infer/pipeline"]["self_ms"] < table[
        "infer/pipeline"]["host_ms"]
    assert len(out) == len(plain)
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_profiler_sees_every_stage_as_a_host_range(tiny):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiny()
    ranges = [e.name for e in prof.events()
              if e.name.startswith("infer/")]
    assert sorted(set(ranges)) == sorted(set(STAGES) | {"infer/pipeline"})
    assert ranges.count("infer/solve") == 2


#: The training step's spans inside ``train/losses``, in order: anchor
#: targets come before the RPN's losses, proposal targets after its
#: proposals, so ``train/targets`` opens twice.
TRAIN_STAGES = ["train/backbone", "train/targets", "train/rpn",
                "train/targets", "train/roi_align", "train/heads"]


@pytest.fixture(scope="module")
def train_step_recorded():
    """One CPU training step of a narrow tiny GroupNorm config (float32,
    the fused RoIAlign's plain version) under a recorder."""
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train.step import (Batch, init_train_state,
                                                  make_train_step)
    base = tiny_test_config()
    cfg = dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, fpn_dim=32),
        rpn=dataclasses.replace(base.rpn, conv_dim=64),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas",
                                 fc_dim=128))
    il, ir, gt, _ = synthetic_batch(cfg, 1, seed=3, n_objects=2)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step_fn = make_train_step(cfg, 4, device="cpu")
    with recording() as rec:
        step_fn(state, Batch(il, ir, gt), torch.Generator().manual_seed(1))
    return rec


def test_training_step_records_its_stages_under_losses(train_step_recorded):
    rec = train_step_recorded
    top = sorted((s for s in rec.spans if s.parent is None),
                 key=lambda s: s.t0_ns)
    assert [s.name for s in top] == ["train/losses", "train/backward",
                                     "train/optimizer"]
    losses = top[0]
    under = sorted((s for s in rec.spans if s.parent == "train/losses"),
                   key=lambda s: s.t0_ns)
    assert [s.name for s in under] == TRAIN_STAGES
    assert all(losses.t0_ns <= s.t0_ns <= s.t1_ns <= losses.t1_ns
               for s in under)
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(under, under[1:]))
    assert len(rec.spans) == 3 + len(TRAIN_STAGES)


def test_backward_and_optimizer_follow_the_losses(train_step_recorded):
    spans = {s.name: s for s in train_step_recorded.spans
             if s.parent is None}
    assert spans["train/losses"].t1_ns <= spans["train/backward"].t0_ns
    assert spans["train/backward"].t1_ns <= spans["train/optimizer"].t0_ns
    table = train_step_recorded.per_call(0)
    assert table["train/targets"]["count"] == 2
    assert table["train/losses"]["self_ms"] < table["train/losses"][
        "host_ms"]
