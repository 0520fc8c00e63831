"""The constant cache (``utils/device_constants.py``) on the CPU.

Every per-call constant of the pipeline and the training step (anchors,
``mean_dims`` of shape [3] and [K-1, 3], ``stds``, the default content
extent, a pipeline's calibration batch) comes from the cache with the bits
of a fresh build; another shape, content or device gets a tensor of its
own; a warm pipeline call and a warm training step build nothing, and
write into no kept tensor.  The export's side (no fake tensor kept) is in
``tests/test_torch_serving.py``, on its artifact.  The tiny config: a few
seconds in all.
"""

import dataclasses

import pytest
import torch

from stereo_rcnn_tpu_torch import inference as t_inf
from stereo_rcnn_tpu_torch.config import (synthetic_multiclass_config,
                                          tiny_test_config)
from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_batch,
                                                  synthetic_images)
from stereo_rcnn_tpu_torch.geometry import anchors as t_anchors
from stereo_rcnn_tpu_torch.models.detector import init_params
from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                         make_train_step)
from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch
from stereo_rcnn_tpu_torch.utils import device_constants as dc
from tests.torch_threads import one_torch_thread  # noqa: F401

# The tiny config's image and the cells' 1280x384.
SHAPES = [(128, 256), (384, 1280)]


def _cfg():
    """The tiny config with frozen BN, float32 and the fused RoIAlign,
    whose plain version reads the kept level tables."""
    base = tiny_test_config()
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    il, ir, calib = synthetic_images(cfg, 2, seed=5, n_objects=2)
    return cfg, model, torch.from_numpy(il), torch.from_numpy(ir), calib


@pytest.mark.parametrize("h, w", SHAPES)
@pytest.mark.parametrize("off", [0, 1])
def test_anchors_equal_a_fresh_build(h, w, off):
    """The kept anchors are the numpy build's bits, handed out as one
    tensor until the cache is cleared."""
    cfg = tiny_test_config().anchors
    fresh = torch.from_numpy(t_anchors._anchors(cfg, h, w, off))
    kept = t_anchors.generate_anchors(cfg, h, w, off, "cpu")
    assert t_anchors.generate_anchors(cfg, h, w, off, "cpu") is kept
    assert kept.dtype == torch.float32 and torch.equal(kept, fresh)
    assert kept.shape[0] == sum(t_anchors.anchors_per_level(cfg, h, w))
    dc.clear()
    rebuilt = t_anchors.generate_anchors(cfg, h, w, off, "cpu")
    assert rebuilt is not kept and torch.equal(rebuilt, fresh)


@pytest.mark.parametrize("make", [tiny_test_config,
                                  synthetic_multiclass_config])
def test_config_tables_equal_a_fresh_build(make):
    """``mean_dims`` ([3] for one class, [2, 3] for Car and Van) and
    ``stds`` as ``torch.tensor`` builds them, kept once."""
    rc = make().rcnn
    for kind, values in (("mean_dims", rc.mean_dims_hwl),
                         ("stds", rc.bbox_target_stds)):
        fresh = torch.tensor(values, dtype=torch.float32)
        kept = dc.table(kind, values, "cpu")
        assert dc.table(kind, values, "cpu") is kept
        assert kept.shape == fresh.shape and torch.equal(kept, fresh)
    assert dc.table("mean_dims", rc.mean_dims_hwl, "cpu").reshape(
        -1, 3).shape[0] == rc.num_classes - 1


@pytest.mark.parametrize("b", [1, 2])
def test_pipeline_constants_equal_a_fresh_build(tiny, monkeypatch, b):
    """``make_full_pipeline(cfg, calib)`` hands the solve the kept
    calibration batch (the same tensors on a second call) with
    ``broadcast_calib``'s bits, and its outputs are those of the pipeline
    given a fresh calibration batch and content extent."""
    cfg, model, left, right, calib = tiny
    left, right = left[:b], right[:b]
    seen = []
    solve_and_align = t_inf.solve_and_align

    def spy(det, il, ir, calib_batch, cfg_, content_wh=None):
        seen.append(calib_batch)
        return solve_and_align(det, il, ir, calib_batch, cfg_, content_wh)

    monkeypatch.setattr(t_inf, "solve_and_align", spy)
    pipe = t_inf.make_full_pipeline(cfg, calib)
    kept = pipe(model, left, right)
    pipe(model, left, right)
    monkeypatch.setattr(t_inf, "solve_and_align", solve_and_align)
    fresh = t_inf.broadcast_calib(calib, b, "cpu")
    for first, second, want in zip(*seen, fresh):
        assert second is first
        assert first.shape == want.shape and torch.equal(first, want)
    h, w = left.shape[1:3]
    content_wh = torch.tensor([float(w), float(h)]).expand(b, 2)
    live = t_inf.make_full_pipeline(cfg)(model, left, right, fresh,
                                         content_wh)
    for name, a, c in zip(kept.det._fields, kept.det, live.det):
        assert torch.equal(a, c), name
    for name in ("position", "ry", "z_refined", "residual"):
        assert torch.equal(getattr(kept, name), getattr(live, name)), name


@pytest.mark.parametrize("h, w", SHAPES)
def test_content_extent_equals_a_fresh_build(h, w):
    fresh = torch.tensor([float(w), float(h)])
    kept = dc.table("content_wh", [float(w), float(h)], "cpu")
    assert torch.equal(kept, fresh)
    assert dc.table("content_wh", [float(w), float(h)], "cpu") is kept


def test_keys_part():
    """Another image shape, anchor config, box offset, content, table
    shape or device gets a tensor of its own; a meta tensor (as a tracer
    makes) is handed out but never kept."""
    cfg = tiny_test_config().anchors
    a = t_anchors.generate_anchors(cfg, 128, 256, 0, "cpu")
    wider = dataclasses.replace(cfg, scales=tuple(2 * s for s in cfg.scales))
    for other in (t_anchors.generate_anchors(cfg, 256, 128, 0, "cpu"),
                  t_anchors.generate_anchors(wider, 128, 256, 0, "cpu"),
                  t_anchors.generate_anchors(cfg, 128, 256, 1, "cpu")):
        assert other is not a
        assert other.shape != a.shape or not torch.equal(other, a)
    row = dc.table("stds", (0.1, 0.2), "cpu")
    assert not torch.equal(dc.table("stds", (0.1, 0.3), "cpu"), row)
    assert dc.table("stds", ((0.1, 0.2),), "cpu").shape == (1, 2)
    builds = dc.counts()["anchors"].builds
    meta = t_anchors.generate_anchors(cfg, 128, 256, 0, "meta")
    assert meta.is_meta and meta.shape == a.shape
    assert dc.table("stds", (0.1, 0.2), "meta").is_meta
    assert dc.counts()["anchors"].builds == builds
    assert not [t for t, _ in dc._CACHE.values() if t.is_meta]
    assert t_anchors.generate_anchors(cfg, 128, 256, 0, "cpu") is a


def test_a_write_into_a_kept_tensor_raises():
    kept = dc.table("guard", (1.0, 2.0), "cpu")
    kept.add_(1.0)
    with pytest.raises(RuntimeError, match="written in place"):
        dc.table("guard", (1.0, 2.0), "cpu")
    dc.clear()


def test_warm_calls_build_nothing_and_write_nothing(tiny):
    """After one pipeline call and one training step, a second of each
    builds nothing: the hits rise by the sites each runs.  No kept tensor's
    ``_version`` moves across them."""
    cfg, model, left, right, calib = tiny
    pipe = t_inf.make_full_pipeline(cfg, calib)
    tcfg = tiny_test_config()
    state = init_train_state(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    il, ir, gt, _ = synthetic_batch(tcfg, 2, seed=3, n_objects=2)
    batch = Batch(torch.from_numpy(il), torch.from_numpy(ir),
                  ground_truth_to_torch(gt, "cpu"))
    step = make_train_step(tcfg, device="cpu")

    def both(seed):
        pipe(model, left, right)
        step(state, batch, torch.Generator().manual_seed(seed))

    both(0)
    versions = {k: t._version for k, (t, _) in dc._CACHE.items()}
    before = dc.counts()
    both(1)
    after = dc.counts()
    assert {k: c.builds for k, c in after.items()} == {
        k: c.builds for k, c in before.items()}
    hits = {k: after[k].hits - before[k].hits for k in after}
    # Pipeline + training step: anchors 1 + 1, mean_dims and stds 1 + 1
    # (post-processing, proposal targets), 7 calibration fields, one
    # content extent; the plain RoIAlign's level tables in both.
    assert {k: hits[k] for k in ("anchors", "mean_dims", "stds", "calib",
                                 "content_wh")} == {
        "anchors": 2, "mean_dims": 2, "stds": 2, "calib": 7,
        "content_wh": 1}
    assert hits["level_table"] > 0
    assert {k: t._version for k, (t, _) in dc._CACHE.items()} == versions
