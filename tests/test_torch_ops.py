"""Parity of the port's geometry, NMS and fused stereo RoIAlign with the
JAX package, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.
Tolerances: geometry in float32, 1e-5 absolute on pixel-scale values (the
two frameworks round exp/log differently in the last bit); discrete
outputs (levels, windows, survivor sets, top-k order) exactly; RoIAlign
rows 1e-4 absolute on unit-scale features (the kernel's plain version
weights 4 taps per sample where the TPU kernel runs two f32 hat
matmuls).  The CUDA kernel itself is checked against its plain version
only on a card, in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.geometry import anchors as j_anchors
from stereo_rcnn_tpu.geometry import boxes as j_boxes
from stereo_rcnn_tpu.geometry import projection as j_proj
from stereo_rcnn_tpu.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu.ops import nms as j_nms
from stereo_rcnn_tpu.ops.roi_align import fpn_level_assignment as j_levels
from stereo_rcnn_tpu.ops.roi_align_pallas import (
    _STEREO_WIN, _roi_window_meta, stereo_roi_align_batched_packed)
from stereo_rcnn_tpu.config import AnchorConfig as JAnchorConfig
from stereo_rcnn_tpu_torch.config import AnchorConfig
from stereo_rcnn_tpu_torch.geometry import anchors as t_anchors
from stereo_rcnn_tpu_torch.geometry import boxes as t_boxes
from stereo_rcnn_tpu_torch.geometry import projection as t_proj
from stereo_rcnn_tpu_torch.ops import nms as t_nms
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra
from stereo_rcnn_tpu_torch.ops.roi_align import fpn_level_assignment

STRIDES = (4, 8, 16, 32)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _random_boxes(rng, n, w=1280.0, h=384.0):
    xy = rng.uniform(-20, [w, h], size=(n, 2))
    wh = rng.uniform(1, [400, 200], size=(n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("off", [0.0, 1.0])
def test_box_coder_iou_clip_union(off):
    rng = np.random.RandomState(0)
    anchors = _random_boxes(rng, 64)
    left = _random_boxes(rng, 64)
    right = left - np.float32([20, 0, 25, 0])
    deltas = rng.randn(64, 6).astype(np.float32)
    t = torch.from_numpy
    enc_j = j_boxes.encode_stereo_boxes(anchors, left, right, off)
    enc_t = t_boxes.encode_stereo_boxes(t(anchors), t(left), t(right), off)
    np.testing.assert_allclose(_np(enc_t), np.asarray(enc_j), atol=1e-5)
    for a, b in zip(t_boxes.decode_stereo_boxes(t(anchors), t(deltas), off),
                    j_boxes.decode_stereo_boxes(anchors, deltas, off)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-3)
    np.testing.assert_allclose(
        _np(t_boxes.pairwise_iou(t(left), t(anchors), off)),
        np.asarray(j_boxes.pairwise_iou(left, anchors, off)), atol=1e-6)
    np.testing.assert_array_equal(
        _np(t_boxes.clip_boxes(t(left), 384, 1280, off)),
        np.asarray(j_boxes.clip_boxes(left, 384, 1280, off)))
    np.testing.assert_array_equal(
        _np(t_boxes.union_box(t(left), t(right))),
        np.asarray(j_boxes.union_box(left, right)))


@pytest.mark.parametrize("off", [0.0, 1.0])
def test_anchors_match(off):
    np.testing.assert_array_equal(
        _np(t_anchors.generate_anchors(AnchorConfig(), 384, 1280, off,
                                       "cpu")),
        np.asarray(j_anchors.generate_anchors(JAnchorConfig(), 384, 1280,
                                              off)))


def test_projection_matches():
    rng = np.random.RandomState(1)
    center = rng.uniform([-10, 1, 5], [10, 2, 40], (16, 3)).astype(np.float32)
    dims = rng.uniform(1.4, 4.5, (16, 3)).astype(np.float32)
    ry = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    calib = default_kitti_calib()
    t = torch.from_numpy
    for right in (False, True):
        np.testing.assert_allclose(
            _np(t_proj.project_box3d(t(center), t(dims), t(ry), calib,
                                     right)),
            np.asarray(j_proj.project_box3d(center, dims, ry, calib, right)),
            atol=1e-3)


@pytest.mark.parametrize("off", [0.0, 1.0])
def test_nms_survivors_with_ties_and_padding(off):
    """Survivor sets and their order on clustered boxes, equal scores, a
    padded (-1, invalid) tail and fewer candidates than top_k."""
    rng = np.random.RandomState(2)
    base = _random_boxes(rng, 12)
    boxes = np.concatenate([base + rng.randn(12, 4).astype(np.float32) * 3
                            for _ in range(4)])                      # 48
    scores = np.round(rng.uniform(0, 1, 48), 1).astype(np.float32)   # ties
    scores[40:] = -1.0                                               # pad
    valid = scores >= 0
    idx_j, ok_j = j_nms.nms_indices(boxes, scores, 0.5, 64, valid=valid,
                                    off=off)
    idx_t, ok_t = t_nms.nms_indices(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None], 0.5, 64,
                                    valid=torch.from_numpy(valid)[None],
                                    off=off)
    np.testing.assert_array_equal(_np(ok_t[0]), np.asarray(ok_j))
    np.testing.assert_array_equal(_np(idx_t[0]), np.asarray(idx_j))
    mask_j = j_nms.nms_mask(boxes, scores, 0.5, valid=valid, off=off)
    mask_t = t_nms.nms_mask(torch.from_numpy(boxes)[None],
                            torch.from_numpy(scores)[None], 0.5,
                            valid=torch.from_numpy(valid)[None], off=off)
    np.testing.assert_array_equal(_np(mask_t[0]), np.asarray(mask_j))


def test_top_k_tie_order_matches_lax():
    x = np.float32([0.5, 0.9, 0.5, -1, 0.9, 0.5, -1, 0.1])
    v_j, i_j = jax.lax.top_k(jnp.asarray(x), 6)
    v_t, i_t = t_nms.top_k_stable(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(_np(v_t), np.asarray(v_j))


# ---------------------------------------------------------------------------
# Fused stereo RoIAlign (K1) at the 1280x384 level shapes, few channels.
# ---------------------------------------------------------------------------

def _k1_inputs(dtype=np.float32, c=8, b=2, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    fl = [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes]
    fr = [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes]
    rois = _random_boxes(rng, 28).tolist()
    rois[0] = [100.0, 100.0, 400.0, 140.0]   # 300x40 px: P2, 75 cells wide
    rois[1] = [50.0, 100.0, 1250.0, 200.0]   # 1200x100 px: P4, 75 cells
    rois[2] = [10.0, 10.0, 10.0, 10.0]       # zero area
    rois[3] = [1400.0, 500.0, 1500.0, 600.0]  # fully outside the image
    rois[4] = [600.0, 150.0, 606.0, 160.0]   # tiny, P2
    rois[5] = [0.0, 0.0, 1279.0, 383.0]      # whole image, P5
    rl = np.stack([np.float32(rois), np.float32(rois[::-1])])
    rr = rl - np.float32([17, 0, 14, 0])
    if dtype is not np.float32:
        # bf16 features: round once, hand the same values to both sides.
        fl = [np.asarray(jnp.asarray(f, jnp.bfloat16)) for f in fl]
        fr = [np.asarray(jnp.asarray(f, jnp.bfloat16)) for f in fr]
    return fl, fr, rl, rr


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def test_k1_levels_cover_every_level_and_clamp():
    _, _, rl, _ = _k1_inputs()
    levels = _np(fpn_level_assignment(torch.from_numpy(rl), 4))
    np.testing.assert_array_equal(levels, np.asarray(j_levels(rl, 4)))
    assert set(levels.ravel().tolist()) == {0, 1, 2, 3}
    # The two wide rois exceed their 64-cell window at P2 and P4.
    assert levels[0, 0] == 0 and levels[0, 1] == 2
    assert (rl[0, 0, 2] - rl[0, 0, 0]) / 4 > _STEREO_WIN[0][1]
    assert (rl[0, 1, 2] - rl[0, 1, 0]) / 16 > _STEREO_WIN[2][1]


def test_k1_window_meta_matches_jax():
    _, _, rl, _ = _k1_inputs()
    shapes = [(384 // s, 1280 // s) for s in STRIDES]
    win = t_sra.window_shapes(shapes)
    meta_t, geom_t = t_sra.roi_window_meta(shapes, torch.from_numpy(rl[0]),
                                           STRIDES)
    meta_j, geom_j = _roi_window_meta(shapes, win, jnp.asarray(rl[0]),
                                      STRIDES, 14)
    np.testing.assert_array_equal(_np(meta_t), np.asarray(meta_j))
    np.testing.assert_allclose(_np(geom_t), np.asarray(geom_j), atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_plain_matches_jax_kernel(bf16):
    """stereo_roi_align_packed_ref == the Pallas kernel (interpret mode),
    all 294 rows, every level, the zero-area and out-of-image rois, and
    rois wider than their window.  bf16 features are rounded once and fed
    to both; each side accumulates in f32, so the tolerance is unchanged."""
    fl, fr, rl, rr = _k1_inputs(jnp.bfloat16 if bf16 else np.float32)
    ref = stereo_roi_align_batched_packed(
        tuple(jnp.asarray(f) for f in fl), tuple(jnp.asarray(f) for f in fr),
        jnp.asarray(rl), jnp.asarray(rr), STRIDES, 7, 14, None, "f32")
    out = t_sra.stereo_roi_align_packed(
        [_to_torch(f) for f in fl], [_to_torch(f) for f in fr],
        torch.from_numpy(rl), torch.from_numpy(rr), STRIDES)
    assert out.dtype == torch.float32 and out.shape == (2, 28, 294, 8)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-4)
    assert float(out[0, 2].abs().max()) == 0.0          # zero-area roi


def test_k1_wrapper_on_cpu_takes_plain_version():
    fl, fr, rl, rr = _k1_inputs()
    t = [torch.from_numpy(f) for f in fl], [torch.from_numpy(f) for f in fr]
    before = t_sra.stereo_roi_align_kernel.launches
    out = t_sra.stereo_roi_align_packed(*t, torch.from_numpy(rl),
                                        torch.from_numpy(rr), STRIDES)
    ref = t_sra.stereo_roi_align_packed_ref(*t, torch.from_numpy(rl),
                                            torch.from_numpy(rr), STRIDES)
    assert torch.equal(out, ref)
    assert t_sra.stereo_roi_align_kernel.launches == before
