"""The port's public geometry and solve helpers against the JAX package's,
on the CPU, in float32: the twins of ``tests/test_anchors.py``,
``tests/test_solver.py`` (through ``solve_pose`` and ``solve_batch``) and
``tests/test_dense_align.py`` (through ``align_depth``), plus the plain
box codec (``encode_boxes`` / ``decode_boxes``) for ``off`` 0 and 1.

Each twin makes the same inputs with numpy, runs both packages, holds the
port to the JAX output and then to the JAX test's own assertions.
Tolerances: anchors exactly; projected pixels and box codes 1e-4
relative to their largest magnitude (float32 through the same formulas,
with ``atan2``/``cos`` from two libraries); solved positions 1e-3 m and
yaws 1e-4 rad on well-posed detections (the pose from its own exact
projections, or with the truncated edges' constraints dropped); the
aligned depth 1e-4 m (both sweeps pick the same candidate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import geometry as jg
from stereo_rcnn_tpu import solve as js
from stereo_rcnn_tpu.config import AnchorConfig as JAnchorConfig
from stereo_rcnn_tpu.config import SolverConfig as JSolverConfig
from stereo_rcnn_tpu_torch import geometry as tg
from stereo_rcnn_tpu_torch import solve as ts
from stereo_rcnn_tpu_torch.config import AnchorConfig, SolverConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

CALIB = tg.default_kitti_calib()


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(ours, theirs, rel=1e-4, name=""):
    theirs = np.asarray(theirs, np.float64)
    ours = np.asarray(ours, np.float64)
    assert ours.shape == theirs.shape, name
    scale = max(float(np.abs(theirs).max()), 1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * scale,
                               err_msg=name)


def test_exports_match_jax_names():
    """``geometry`` and ``solve`` export what the JAX packages export."""
    for ours, theirs in ((tg, jg), (ts, js)):
        names = {n for n in dir(theirs) if not n.startswith("_")
                 and not isinstance(getattr(theirs, n), type(np))}
        assert names <= set(dir(ours)), names - set(dir(ours))


# -- twins of tests/test_anchors.py ---------------------------------------

def test_base_anchor_areas():
    b = tg.base_anchors(64.0, (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(
        b, np.asarray(jg.base_anchors(64.0, (0.5, 1.0, 2.0))))
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    np.testing.assert_allclose(areas, 64.0 ** 2, rtol=1e-5)
    ratios = (b[:, 3] - b[:, 1]) / (b[:, 2] - b[:, 0])
    np.testing.assert_allclose(ratios, [0.5, 1.0, 2.0], rtol=1e-5)


@pytest.mark.parametrize("hw", [(128, 256), (375, 1242)])
def test_anchor_counts_and_layout(hw):
    h, w = hw
    cfg, cfg_j = AnchorConfig(), JAnchorConfig()
    anchors = tg.generate_anchors(cfg, h, w, device="cpu").numpy()
    counts = tg.anchors_per_level(cfg, h, w)
    assert counts == jg.anchors_per_level(cfg_j, h, w)
    assert (tg.level_shapes(h, w, cfg.strides) ==
            jg.level_shapes(h, w, cfg_j.strides))
    np.testing.assert_array_equal(
        anchors, np.asarray(jg.generate_anchors(cfg_j, h, w)))
    assert anchors.shape == (sum(counts), 4)
    fh, fw = tg.level_shapes(h, w, cfg.strides)[0]
    assert counts[0] == fh * fw * 3 == -(-h // 4) * -(-w // 4) * 3
    c0 = anchors[0]
    np.testing.assert_allclose([(c0[0] + c0[2]) / 2, (c0[1] + c0[3]) / 2],
                               [2.0, 2.0], atol=1e-4)


def test_projection_roundtrip():
    pt = np.float32([[-CALIB.tx2, 0.0, 10.0]])
    uv = tg.project(_t(pt), CALIB)
    uv_r = tg.project(_t(pt), CALIB, right=True)
    _close(uv, jg.project(jnp.asarray(pt), CALIB), name="uv")
    _close(uv_r, jg.project(jnp.asarray(pt), CALIB, right=True), name="uv_r")
    np.testing.assert_allclose(float(uv[0, 0]), CALIB.cu, atol=1e-3)
    disp = float(CALIB.f * CALIB.baseline / 10.0)
    np.testing.assert_allclose(float(uv[0, 0] - uv_r[0, 0]), disp, atol=1e-3)

    c, d = np.float32([0.0, 1.6, 15.0]), np.float32([1.5, 1.6, 3.9])
    box_l = tg.box2d_from_3d(_t(c), _t(d), _t(0.3), CALIB)
    box_r = tg.box2d_from_3d(_t(c), _t(d), _t(0.3), CALIB, right=True)
    _close(box_l, jg.box2d_from_3d(jnp.asarray(c), jnp.asarray(d),
                                   jnp.asarray(0.3), CALIB), name="box_l")
    _close(box_r, jg.box2d_from_3d(jnp.asarray(c), jnp.asarray(d),
                                   jnp.asarray(0.3), CALIB, right=True),
           name="box_r")
    assert box_l[2] > box_l[0] and box_l[3] > box_l[1]
    assert float(box_r[0]) < float(box_l[0])


def test_pose_helpers_match_jax():
    """The keypoint, viewpoint and yaw helpers over a batch of random
    poses (every yaw quadrant), and ``ry_from_alpha`` inverting
    ``viewpoint_alpha``."""
    rng = np.random.RandomState(0)
    n = 64
    center = np.stack([rng.uniform(-10, 10, n), rng.uniform(1.4, 1.9, n),
                       rng.uniform(5, 60, n)], -1).astype(np.float32)
    dims = rng.uniform([1.3, 1.4, 3.2], [2.4, 2.0, 5.5],
                       (n, 3)).astype(np.float32)
    ry = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    jc, jd, jr = jnp.asarray(center), jnp.asarray(dims), jnp.asarray(ry)
    tc, td, tr = _t(center), _t(dims), _t(ry)
    _close(tg.perspective_keypoints(tc, td, tr, CALIB),
           jg.perspective_keypoints(jc, jd, jr, CALIB), name="kpts")
    np.testing.assert_array_equal(
        tg.visible_keypoint_index(tc, tr).numpy(),
        np.asarray(jg.visible_keypoint_index(jc, jr)))
    alpha = tg.viewpoint_alpha(tc, tr)
    _close(alpha, jg.viewpoint_alpha(jc, jr), name="alpha")
    back = tg.ry_from_alpha(alpha, tc[:, 0], tc[:, 2])
    _close(back, jg.ry_from_alpha(jnp.asarray(alpha.numpy()), jc[:, 0],
                                  jc[:, 2]), name="ry")
    np.testing.assert_allclose(back.numpy(), ry, atol=1e-5)


@pytest.mark.parametrize("off", [0.0, 1.0])
def test_plain_box_codec_matches_jax(off):
    rng = np.random.RandomState(int(off) + 1)
    xy = rng.uniform(0, 400, (2, 50, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(8, 120, (2, 50, 2))],
                             -1).astype(np.float32)
    gt = (anchors + rng.randn(2, 50, 4) * 6).astype(np.float32)
    gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 2)
    deltas = tg.encode_boxes(_t(anchors), _t(gt), off)
    _close(deltas, jg.encode_boxes(jnp.asarray(anchors), jnp.asarray(gt),
                                   off), name="encode")
    assert deltas.shape == (2, 50, 4)
    boxes = tg.decode_boxes(_t(anchors), deltas, off)
    _close(boxes, jg.decode_boxes(jnp.asarray(anchors),
                                  jnp.asarray(deltas.numpy()), off),
           name="decode")
    # The round trip returns the box; under off = 1 the decode keeps the
    # reference's asymmetry (the width counts the end pixel, x2 = ctr +
    # w / 2 has no - 1): x2 and y2 come back one pixel further.
    shift = np.float32([0.0, 0.0, 1.0, 1.0]) * off
    np.testing.assert_allclose(boxes.numpy(), gt + shift, atol=2e-3)


# -- twins of tests/test_solver.py ----------------------------------------

def _make_obs(g, s, center, dims, ry, as_array):
    c, d, r = (as_array(np.asarray(v, np.float32)) for v in (center, dims,
                                                             ry))
    box_l = g.box2d_from_3d(c, d, r, CALIB)
    box_r = g.box2d_from_3d(c, d, r, CALIB, right=True)
    kpts = g.perspective_keypoints(c, d, r, CALIB)
    kidx = g.visible_keypoint_index(c, r)
    obs = s.observations_from_detection(box_l, box_r, kpts[kidx])
    return obs, d, g.viewpoint_alpha(c, r), kidx


def _both_obs(center, dims, ry):
    ours = _make_obs(tg, ts, center, dims, ry, torch.from_numpy)
    theirs = _make_obs(jg, js, center, dims, ry, jnp.asarray)
    _close(ours[0], theirs[0], name="obs")
    assert int(ours[3]) == int(theirs[3])
    return ours, theirs


def _same_pose(ours, theirs):
    np.testing.assert_allclose(ours.position.numpy(),
                               np.asarray(theirs.position), atol=1e-3)
    np.testing.assert_allclose(ours.theta.numpy(), np.asarray(theirs.theta),
                               atol=1e-4)


def test_solve_recovers_pose():
    center, dims, ry = [2.0, 1.65, 18.0], [1.5, 1.6, 3.9], 0.4
    ours, theirs = _both_obs(center, dims, ry)
    res = ts.solve_pose(*ours, CALIB, iters=50)
    _same_pose(res, js.solve_pose(*theirs, CALIB, iters=50))
    np.testing.assert_allclose(res.position.numpy(), center, atol=0.05)
    np.testing.assert_allclose(float(res.theta), ry, atol=0.02)
    assert float(res.residual) < 0.5


def test_solve_batch_various_poses():
    cases = [
        ([-3.0, 1.6, 12.0], [1.45, 1.6, 3.6], -0.8),
        ([0.5, 1.7, 30.0], [1.6, 1.7, 4.2], 1.2),
        ([5.0, 1.5, 25.0], [1.5, 1.6, 3.9], 3.0),
        ([-1.0, 1.6, 8.0], [1.5, 1.6, 3.9], -2.5),
    ]
    pairs = [_both_obs(*case) for case in cases]
    res = ts.solve_batch(*[torch.stack([p[0][i] for p in pairs])
                           for i in range(4)], CALIB, iters=60)
    res_j = js.solve_batch(*[jnp.stack([p[1][i] for p in pairs])
                             for i in range(4)], CALIB, iters=60)
    _same_pose(res, res_j)
    for i, (c, _, r) in enumerate(cases):
        np.testing.assert_allclose(res.position[i].numpy(), c, atol=0.15)
        dr = (float(res.theta[i]) - r + np.pi) % (2 * np.pi) - np.pi
        assert abs(dr) < 0.05, (i, float(res.theta[i]), r)


def test_solve_fixed_z():
    center, dims, ry = [1.0, 1.6, 20.0], [1.5, 1.6, 3.9], 0.3
    ours, theirs = _both_obs(center, dims, ry)
    res = ts.solve_pose(*ours, CALIB, iters=50, fixed_z=center[2])
    _same_pose(res, js.solve_pose(*theirs, CALIB, iters=50,
                                  fixed_z=jnp.asarray(center[2])))
    np.testing.assert_allclose(float(res.position[2]), center[2], atol=1e-6)
    np.testing.assert_allclose(res.position[:2].numpy(), center[:2],
                               atol=0.05)


@pytest.mark.parametrize("center", [[-7.5, 1.65, 9.0], [-9.0, 1.65, 9.0]])
def test_solve_truncated_edge_constraints_dropped(center):
    """A car clipped by the left border (keypoint visible, then clipped
    too): with the clipped edges' constraints dropped the pose is
    recovered, and both packages agree; fed the clipped edges as they are,
    the solve is skewed."""
    dims, ry = [1.5, 1.6, 3.9], 0.3
    ours, theirs = _both_obs(center, dims, ry)
    assert float(ours[0][0]) < 0.0
    kpt_ok = float(ours[0][6]) > 1.5
    w = np.float32([0, 1, 1, 1, 0, 1, 1.0 if kpt_ok else 0.0])
    obs_clip = torch.clamp(ours[0], min=0.0)
    res_w = ts.solve_pose(obs_clip, *ours[1:], CALIB,
                          obs_weights=torch.from_numpy(w), iters=60)
    res_w_j = js.solve_pose(jnp.maximum(theirs[0], 0.0), *theirs[1:], CALIB,
                            obs_weights=jnp.asarray(w), iters=60)
    _same_pose(res_w, res_w_j)
    res_raw = ts.solve_pose(obs_clip, *ours[1:], CALIB, iters=60)
    err_w = float(torch.linalg.norm(res_w.position - _t(center)))
    err_raw = float(torch.linalg.norm(res_raw.position - _t(center)))
    assert err_w < 0.25, (center, err_w)
    assert err_raw > 2 * err_w, (center, err_raw, err_w)


# -- twins of tests/test_dense_align.py -----------------------------------

def _textured_pair(z_visible, h=200, w=800):
    rng = np.random.RandomState(3)
    left = rng.rand(h, w).astype(np.float32)
    from numpy.lib.stride_tricks import sliding_window_view
    pad = np.pad(left, 2, mode="edge")
    left = (sliding_window_view(pad, (5, 5)) / 25.0).sum(
        axis=(2, 3)).astype(np.float32)
    disp = float(CALIB.f * CALIB.baseline / z_visible)
    src = np.clip(np.arange(w, dtype=np.float32) + disp, 0, w - 1)
    lo = np.floor(src).astype(int)
    frac = src - lo
    hi = np.minimum(lo + 1, w - 1)
    return left, (left[:, lo] * (1 - frac) + left[:, hi] * frac).astype(
        np.float32)


def test_align_recovers_depth():
    z_true = 15.0
    center, dims = np.float32([0.0, 1.6, z_true]), np.float32([1.5, 1.6,
                                                               3.9])
    ry = np.float32(np.pi / 2)
    left, right = _textured_pair(z_true - float(dims[2]) / 2)
    kw = dict(align_coarse_range=3.0, align_coarse_candidates=31,
              align_fine_range=0.3, align_fine_candidates=25,
              align_grid_h=16, align_grid_w=32)
    box_l = tg.box2d_from_3d(_t(center), _t(dims), _t(ry), CALIB)
    border = torch.stack([box_l[0], box_l[2]])
    pos = np.float32([0.0, 1.6, z_true + 1.3])
    res = ts.align_depth(_t(left), _t(right), box_l, border, _t(pos),
                         float(ry), _t(dims), CALIB, SolverConfig(**kw),
                         True)
    box_j = jnp.asarray(box_l.numpy())
    res_j = js.align_depth(jnp.asarray(left), jnp.asarray(right), box_j,
                           jnp.stack([box_j[0], box_j[2]]),
                           jnp.asarray(pos), jnp.asarray(ry),
                           jnp.asarray(dims), CALIB, JSolverConfig(**kw),
                           jnp.asarray(True))
    assert res.z.shape == ()
    np.testing.assert_allclose(float(res.z), float(res_j.z), atol=1e-4)
    np.testing.assert_allclose(float(res.error), float(res_j.error),
                               rtol=1e-4)
    assert abs(float(res.z) - z_true) < 0.1, float(res.z)


def test_align_invalid_passthrough():
    kw = dict(align_grid_h=4, align_grid_w=8, align_coarse_candidates=5,
              align_fine_candidates=3)
    img = np.zeros((50, 100), np.float32)
    args = (np.float32([10.0, 10.0, 40.0, 40.0]), np.float32([12.0, 38.0]),
            np.float32([0.0, 1.0, 9.0]))
    res = ts.align_depth(_t(img), _t(img), *map(_t, args), 0.1,
                         _t([1.5, 1.6, 3.9]), CALIB, SolverConfig(**kw),
                         False)
    res_j = js.align_depth(jnp.asarray(img), jnp.asarray(img),
                           *map(jnp.asarray, args), jnp.asarray(0.1),
                           jnp.asarray([1.5, 1.6, 3.9]), CALIB,
                           JSolverConfig(**kw), jnp.asarray(False))
    np.testing.assert_allclose(float(res.z), 9.0)
    assert float(res_j.z) == float(res.z)
    assert np.isinf(float(res.error)) and np.isinf(float(res_j.error))
