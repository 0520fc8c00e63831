"""Degenerate inputs through the port, held to the JAX package on the same
inputs, on the CPU, in float32: the twin of
``tests/test_degenerate_inputs.py``.

Probes: identical duplicated boxes (one survivor), NaN scores (never
win), a zero-area and fully out-of-image RoIs (finite, equal to JAX's),
an all-background (blank) stereo pair through the whole pipeline, and a
scene with more objects than ``max_detections`` (the padded output
saturates, never overflows).

The pipeline probes use the tiny GroupNorm config in float32 with its
atlas gather RoIAlign, one JAX initialisation for both packages
(``convert.from_jax``), and ``tests/test_torch_pipeline.py``'s output
scalings, so scores saturate and ties break by index in both packages.
Tolerances: RoIAlign outputs 1e-5 relative to their largest magnitude;
validity exactly; boxes 1e-3 px; scores 1e-4; positions finite (a blank
pair or random weights give boxes no 3D car fits, so positions are not
compared: ``tests/test_torch_pipeline.py`` explains why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import synthetic_batch as j_synthetic
from stereo_rcnn_tpu.models import detector as j_det
from stereo_rcnn_tpu.ops import nms_mask as j_nms_mask
from stereo_rcnn_tpu.ops import roi_align as j_roi_align
from stereo_rcnn_tpu_torch import inference as t_inf
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.models import detector as t_det
from stereo_rcnn_tpu_torch.ops.nms import nms_mask
from stereo_rcnn_tpu_torch.ops.roi_align import roi_align
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_torch_pipeline.py's output-layer scalings.
CLS_SCALE, RPN_SCALE, RPN_BOX_SCALE, BOX_SCALE = 300.0, 300.0, 0.01, 0.1


def _nms_both(boxes, scores, thresh=0.5):
    ours = nms_mask(torch.from_numpy(boxes)[None],
                    torch.from_numpy(scores)[None], thresh)[0].numpy()
    theirs = np.asarray(j_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                   thresh))
    np.testing.assert_array_equal(ours, theirs)
    return ours


def test_nms_identical_duplicates_keep_exactly_one():
    boxes = np.tile(np.float32([10.0, 10.0, 50.0, 50.0]), (16, 1))
    keep = _nms_both(boxes, np.full((16,), 0.7, np.float32))
    assert keep.sum() == 1
    assert keep[0]


def test_nms_nan_scores_never_win():
    boxes = np.float32([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30]])
    keep = _nms_both(boxes, np.float32([np.nan, 0.9, np.nan]))
    assert keep[1]


@pytest.mark.parametrize("feat_hw, rois", [
    ((32, 32), [[12.0, 9.0, 12.0, 9.0]]),                 # zero area
    ((16, 16), [[100.0, 100.0, 140.0, 140.0],             # fully outside
                [-50.0, -50.0, -10.0, -10.0]]),           # negative side
], ids=["zero_area", "out_of_image"])
def test_roi_align_degenerate_rois_are_finite(feat_hw, rois):
    h, w = feat_hw
    feat = np.arange(h * w * 4, dtype=np.float32).reshape(h, w, 4) / (h * w)
    rois = np.float32(rois)
    ours = roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                     output_size=7, spatial_scale=1.0).numpy()
    theirs = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                    output_size=7, spatial_scale=1.0))
    assert ours.shape == (len(rois), 7, 7, 4)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * max(np.abs(theirs).max(), 1.0))


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' full pipeline on one JAX initialisation (batch 1)."""
    cfg_j = j_tiny().replace(compute_dtype="float32")
    cfg = tiny_test_config().replace(compute_dtype="float32")
    params = jax.tree.map(np.array, j_det.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    p = params["params"]
    p["rcnn_head"]["cls_score"]["kernel"] *= CLS_SCALE
    p["rpn_head"]["rpn_cls"]["kernel"] *= RPN_SCALE
    p["rpn_head"]["rpn_box"]["kernel"] *= RPN_BOX_SCALE
    p["rcnn_head"]["bbox_pred"]["kernel"] *= BOX_SCALE
    model = t_det.build_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    jfn = jax.jit(j_inf.make_full_pipeline(cfg_j))
    jparams = jax.tree.map(jnp.asarray, params)
    tfn = t_inf.make_full_pipeline(cfg)

    def both(il, ir, calib):
        theirs = jfn(jparams, jnp.asarray(il), jnp.asarray(ir),
                     j_inf.broadcast_calib(calib, 1))
        ours = tfn(model, torch.from_numpy(il), torch.from_numpy(ir),
                   t_inf.broadcast_calib(calib, 1, "cpu"))
        valid = np.asarray(theirs.det.valid)
        np.testing.assert_array_equal(ours.det.valid.numpy(), valid)
        for name, tol in (("box_left", 1e-3), ("box_right", 1e-3),
                          ("score", 1e-4)):
            np.testing.assert_allclose(
                getattr(ours.det, name).numpy()[valid],
                np.asarray(getattr(theirs.det, name))[valid], atol=tol,
                err_msg=name)
        assert np.isfinite(ours.det.score.numpy()).all()
        assert np.isfinite(ours.det.box_left.numpy()).all()
        assert np.isfinite(ours.position.numpy()).all()
        assert np.isfinite(np.asarray(theirs.position)).all()
        return ours

    return cfg, both


def test_detector_all_background_image(pipelines):
    """A blank pair flows through RPN, NMS, heads, the 3D solve and dense
    alignment with finite outputs and fixed shapes."""
    cfg, both = pipelines
    h, w = cfg.data.image_h, cfg.data.image_w
    _, _, calib = synthetic_images(cfg, 1, seed=0, n_objects=1)
    blank = np.zeros((1, h, w, 3), np.float32)
    out = both(blank, blank, calib)
    assert out.det.valid.shape == (1, cfg.rcnn.max_detections)


def test_detector_saturation_valid_capped(pipelines):
    """More objects than ``max_detections``: the padded output saturates."""
    cfg, both = pipelines
    il, ir, _, calib = j_synthetic(j_tiny(), batch=1, seed=9,
                                   n_objects=cfg.rcnn.max_detections + 4)
    out = both(np.asarray(il), np.asarray(ir), calib)
    assert out.det.valid.shape == (1, cfg.rcnn.max_detections)
    assert out.det.valid.sum() <= cfg.rcnn.max_detections
