"""Parity of the port's 3D solve, dense alignment, keypoint decode and
truncation weights with the JAX package, on the CPU, in float32.

Detections here are well posed: they come from the 3D boxes of a rendered
synthetic scene (consistent left/right boxes and keypoints, plus 0.3 px
of noise), so the Gauss-Newton solve converges and both packages must
land within 1e-3 m; dense alignment picks the same candidate, so refined
depths agree within 1e-4 m.  The solver's written-out Jacobian is held
to ``torch.func.jvp`` (1e-5 relative).  Keypoint decode and truncation
weights are compared exactly (discrete) or within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu.models.detector import decode_keypoints as j_decode
from stereo_rcnn_tpu.solve import box_estimator as j_box
from stereo_rcnn_tpu.solve import dense_align as j_align
from stereo_rcnn_tpu_torch import inference as t_inf
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.data.synthetic import (_all_corners_cam,
                                                  _project_np, random_scene,
                                                  render_pair)
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu_torch.models.detector import decode_keypoints
from stereo_rcnn_tpu_torch.solve import box_estimator as t_box
from stereo_rcnn_tpu_torch.solve import dense_align as t_align

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 384, 1280


@pytest.fixture(scope="module")
def scene():
    """Two rendered images at 1280x384 and their objects as detections."""
    calib = default_kitti_calib().scale(min(W / 1242.0, H / 375.0))
    rng = np.random.RandomState(3)
    imgs_l, imgs_r, dets = [], [], []
    for _ in range(2):
        objs = random_scene(rng, 4, calib, H, W)
        il, ir = render_pair(objs, calib, H, W, rng)
        imgs_l.append(il.mean(-1))
        imgs_r.append(ir.mean(-1))
        rows = []
        for o in objs:
            corners = _all_corners_cam(o.location, o.dims, o.ry)
            uv_l = _project_np(corners, calib)
            uv_r = _project_np(corners, calib, right=True)
            k = int(np.argmin(corners[:4, 2]))
            rows.append(np.concatenate([
                [uv_l[:, 0].min(), uv_l[:, 1].min(), uv_l[:, 0].max(),
                 uv_l[:, 1].max(), uv_r[:, 0].min(), uv_r[:, 0].max(),
                 uv_l[k, 0]],
                o.dims, [o.alpha, k], o.location, [o.ry]]))
        dets.append(np.float32(rows[:4]))
    d = np.stack(dets)                                     # [2, 4, 16]
    d[..., :7] += rng.randn(*d[..., :7].shape).astype(np.float32) * 0.3
    return calib, np.stack(imgs_l), np.stack(imgs_r), d


def test_solve_batch_matches(scene):
    calib, _, _, d = scene
    flat = d.reshape(-1, d.shape[-1])
    obs, dims, alpha = flat[:, :7], flat[:, 7:10], flat[:, 10]
    kidx = flat[:, 11].astype(np.int32)
    cfg = tiny_test_config().solver
    for fixed in (None, flat[:, 14] + 0.3):
        rj = j_box.solve_batch(obs, dims, alpha, kidx, calib,
                               iters=cfg.gn_iters, fixed_z=fixed)
        rt = t_box.solve_batch(
            torch.from_numpy(obs), torch.from_numpy(dims),
            torch.from_numpy(alpha), torch.from_numpy(kidx),
            t_inf.broadcast_calib(calib, len(obs), "cpu"), iters=cfg.gn_iters,
            fixed_z=None if fixed is None else torch.from_numpy(fixed))
        np.testing.assert_allclose(rt.position.numpy(),
                                   np.asarray(rj.position), atol=1e-3)
        np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta),
                                   atol=1e-4)
        # Converged near the ground truth (a meaningful solve).
        assert np.abs(rt.position.numpy()[:, 2] - flat[:, 14]).max() < 2.0


def _op_args(scene, fixed):
    """The registered op's arguments for the scene's detections, as
    ``solve_batch`` passes them, and ``solve_batch_ref``'s."""
    calib, _, _, d = scene
    flat = d.reshape(-1, d.shape[-1])
    n = len(flat)
    obs, dims, alpha = (torch.from_numpy(flat[:, :7]),
                        torch.from_numpy(flat[:, 7:10]),
                        torch.from_numpy(flat[:, 10]))
    kidx = torch.from_numpy(flat[:, 11].astype(np.int32))
    w = torch.ones((n, 7))
    w[::3, 6] = 0.0                     # some keypoints dropped
    cal = t_inf.broadcast_calib(calib, n, "cpu")
    fz = torch.from_numpy(flat[:, 14] + 0.3) if fixed else None
    op_args = (obs, w, dims, alpha, kidx, *cal[:5], fz, 20, 1e-3)
    ref_args = (obs, dims, alpha, kidx, cal, w, 20, 1e-3, fz)
    return op_args, ref_args


@pytest.mark.parametrize("fixed", [False, True])
def test_registered_op_gives_the_plain_loops_bits(scene, fixed):
    """``stereo_rcnn_tpu_torch::gauss_newton_solve`` on CPU tensors, and
    ``solve_batch`` through it, give ``solve_batch_ref``'s bits, with z
    free and fixed."""
    op_args, ref_args = _op_args(scene, fixed)
    ref = t_box.solve_batch_ref(*ref_args)
    got = torch.ops.stereo_rcnn_tpu_torch.gauss_newton_solve(*op_args)
    via = t_box.solve_batch(*ref_args)
    for a, b, c in zip(got, via, ref):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_registered_op_fake_gives_shapes_and_dtypes(scene):
    """The op's fake implementation (what ``torch.export`` traces) gives
    the outputs' shapes and dtypes, and no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op_args, _ = _op_args(scene, True)
    real = torch.ops.stereo_rcnn_tpu_torch.gauss_newton_solve(*op_args)
    with FakeTensorMode() as mode:
        fake = torch.ops.stereo_rcnn_tpu_torch.gauss_newton_solve(
            *[mode.from_tensor(a) if torch.is_tensor(a) else a
              for a in op_args])
    assert [(f.shape, f.dtype) for f in fake] == [
        (r.shape, r.dtype) for r in real] == [
        ((8, 3), torch.float32), ((8,), torch.float32),
        ((8,), torch.float32)]


def test_synthetic_solve_inputs_edge_rows():
    """``synthetic_solve_inputs`` (the card's K5 checks take it): a seed
    gives the same arrays; the edge rows keep every observation, row 0's
    camera has cu = tx2 = 0 and row 1 a disparity of 2000 px; the
    well-posed rows leave out row 1 and rows with more than 2 of 7
    observations dropped; the plain loop floors row 1's fixed z of 0.2 m
    at 0.5 m and its answer is finite."""
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_solve_inputs
    from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
    d = synthetic_solve_inputs(64, 3, edge_rows=True)
    again = synthetic_solve_inputs(64, 3, edge_rows=True)
    assert all(np.array_equal(d[k], again[k]) for k in d)
    assert (d["obs_weights"][:2] == 1).all()
    assert (d["obs_weights"] == 0).any()
    assert (d["calib"][0, [1, 4]] == 0).all()
    np.testing.assert_allclose(d["obs"][1, [0, 2]] - d["obs"][1, [4, 5]],
                               2000.0, rtol=1e-6)
    dropped = (d["obs_weights"] == 0).sum(1)
    expect = dropped <= 2
    expect[1] = False
    np.testing.assert_array_equal(d["well_posed"], expect)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    z = t["depth"].clone()
    z[1] = 0.2
    res = t_box.solve_batch_ref(
        t["obs"], t["dims_hwl"], t["alpha"], t["kpt_idx"],
        StereoCalib(*t["calib"].T.contiguous(), None, None),
        t["obs_weights"], fixed_z=z)
    assert res.position[1, 2].item() == 0.5
    assert all(r.isfinite().all() for r in res)


def test_written_out_jacobian_matches_jvp(scene):
    """_observe_jac's Jacobian == four torch.func.jvp calls (the JAX
    package's formulation), including corners below the z floor."""
    calib, _, _, d = scene
    flat = d.reshape(-1, d.shape[-1])
    state = torch.from_numpy(np.concatenate([flat[:, 12:15],
                                             flat[:, 15:16]], 1))
    state[0, 2] = 0.8                  # some corners behind z = 1e-3
    args = (torch.from_numpy(flat[:, 7:10]),
            torch.from_numpy(flat[:, 11].astype(np.int32)),
            t_inf.broadcast_calib(calib, len(flat), "cpu"))
    pred, jac = t_box._observe_jac(state, *args)
    cols = [torch.func.jvp(lambda s: t_box._observe_jac(s, *args)[0],
                           (state,), (torch.eye(4)[k].expand_as(state),))[1]
            for k in range(4)]
    torch.testing.assert_close(jac, torch.stack(cols, dim=-1), rtol=1e-5,
                               atol=1e-4)
    obs_j = j_box._observe(state.numpy(), flat[:, 7:10],
                           flat[:, 11].astype(np.int32), calib)
    np.testing.assert_allclose(pred.numpy(), np.asarray(obs_j), atol=1e-3)


def test_align_batch_matches(scene):
    calib, gl, gr, d = scene
    cfg = tiny_test_config().solver
    box_left = d[..., 0:4]
    border = np.stack([d[..., 0] + 2, d[..., 2] - 2], -1)
    pos = d[..., 12:15] + np.float32([0, 0, 0.4])
    theta, dims = d[..., 15], d[..., 7:10]
    valid = np.ones(d.shape[:2], bool)
    calib_b = j_inf.broadcast_calib(calib, 2)
    rj = jax.vmap(lambda a, b, c, e, f, g, h, cb, v: j_align.align_batch(
        a, b, c, e, f, g, h, cb, cfg, v))(gl, gr, box_left, border, pos,
                                          theta, dims, calib_b, valid)
    rt = t_align.align_batch(*[torch.from_numpy(x) for x in (
        gl, gr, box_left, border, pos, theta, dims)],
        t_inf.broadcast_calib(calib, 2, "cpu"), cfg, torch.from_numpy(valid))
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), atol=1e-4)
    np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error),
                               rtol=1e-4)
    # Alignment pulled most perturbed depths back toward the truth.
    assert (np.abs(rt.z.numpy() - d[..., 14]) < 0.2).sum() >= 4


@pytest.mark.parametrize("mode", ["joint", "per_channel"])
def test_decode_keypoints_matches(mode):
    rng = np.random.RandomState(4)
    logits = (rng.randn(2, 5, 6, 28) * 3).astype(np.float32)
    rois = np.sort(rng.uniform(0, 300, (2, 5, 4)), -1).astype(np.float32)
    ours = decode_keypoints(torch.from_numpy(logits), torch.from_numpy(rois),
                            mode)
    theirs = jax.vmap(lambda k, r: j_decode(k, r, mode))(logits, rois)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    for a, b in zip(ours[:1] + ours[2:], theirs[:1] + theirs[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_truncation_weights_match():
    rng = np.random.RandomState(5)
    bl = np.float32(rng.choice([0.5, 3.0, 200.0, 1278.0], (6, 4)))
    br = np.float32(rng.choice([0.5, 3.0, 200.0, 1278.0], (6, 4)))
    ku = np.float32(rng.choice([1.0, 50.0, 1279.0], 6))
    kp = np.float32(rng.choice([0.1, 0.5], 6))
    ours = t_inf.truncation_weights(*[torch.from_numpy(x)
                                      for x in (bl, br, ku, kp)], 1280, 384)
    theirs = j_inf.truncation_weights(bl, br, ku, kp, 1280, 384)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
