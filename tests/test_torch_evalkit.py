"""The port's copy of the KITTI evaluator (``evalkit``) pinned to the JAX
package's on the CPU: AP for every metric, threshold and interpolation,
the rotated BEV and 3D IoUs, the unpacking of the pipeline's padded
output, and the result-file writer.

All comparisons are exact: the evaluator is numpy on the host in both
packages, so equal inputs must give equal floats and bytes.
"""

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import evalkit as j_eval
from stereo_rcnn_tpu.data.kitti import KittiObject as JObject
from stereo_rcnn_tpu.inference import Detections3D as JDetections3D
from stereo_rcnn_tpu.models.detector import Detections as JDetections
from stereo_rcnn_tpu.train.targets import GroundTruth as JGroundTruth
from stereo_rcnn_tpu_torch import evalkit as t_eval
from stereo_rcnn_tpu_torch.data.kitti import KittiObject as TObject
from stereo_rcnn_tpu_torch.inference import Detections3D as TDetections3D
from stereo_rcnn_tpu_torch.models.detector import Detections as TDetections
from stereo_rcnn_tpu_torch.train.targets import GroundTruth as TGroundTruth


def _label_frames(rng, n_frames=12):
    """Per frame: Cars of every difficulty (heights, occlusions,
    truncations), a Van, a DontCare region and a Pedestrian, as fields
    from which each package builds its own ``KittiObject`` s."""
    frames = []
    for _ in range(n_frames):
        objs = []
        for k in range(int(rng.randint(2, 7))):
            kind = ("Car", "Car", "Car", "Van", "DontCare",
                    "Pedestrian")[k % 6]
            x1, y1 = rng.uniform(0, 1100), rng.uniform(100, 250)
            h = rng.uniform(15, 120)
            box = np.float32([x1, y1, x1 + h * rng.uniform(1.2, 2.5),
                              y1 + h])
            objs.append(dict(
                type=kind, truncation=float(rng.choice([0.0, 0.0, 0.2,
                                                        0.4, 0.6])),
                occlusion=int(rng.choice([0, 0, 1, 2, 3])),
                alpha=float(rng.uniform(-3, 3)), box=box,
                dims=np.float32([rng.uniform(1.4, 1.8),
                                 rng.uniform(1.5, 1.8),
                                 rng.uniform(3.4, 4.5)]),
                location=np.float32([rng.uniform(-15, 15),
                                     rng.uniform(1.4, 1.9),
                                     rng.uniform(5, 60)]),
                ry=float(rng.uniform(-3.1, 3.1))))
        frames.append(objs)
    return frames


def _detections(rng, frames):
    """Noisy copies of about two thirds of each frame's objects plus
    random false positives, with random scores: (box2d, box3d, score)."""
    dets = []
    for objs in frames:
        b2, b3, sc = [], [], []
        for o in objs:
            if rng.rand() < 0.35:
                continue
            b2.append(o["box"] + rng.randn(4) * 4)
            b3.append(np.concatenate([
                o["location"] + rng.randn(3) * [0.1, 0.02, 0.3],
                o["dims"] + rng.randn(3) * 0.05,
                [o["ry"] + rng.randn() * 0.1]]))
            sc.append(rng.uniform(0.3, 1.0))
        for _ in range(int(rng.randint(0, 3))):
            x1, y1 = rng.uniform(0, 1100), rng.uniform(100, 250)
            b2.append([x1, y1, x1 + 60, y1 + 40])
            b3.append([rng.uniform(-15, 15), 1.6, rng.uniform(5, 60),
                       1.5, 1.6, 3.9, rng.uniform(-3, 3)])
            sc.append(rng.uniform(0.0, 0.7))
        n = len(sc)
        dets.append((np.asarray(b2, np.float64).reshape(n, 4),
                     np.asarray(b3, np.float64).reshape(n, 7),
                     np.asarray(sc)))
    return dets


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    labels = _label_frames(rng)
    return labels, _detections(rng, labels)


def _package_frames(mod, obj_cls, labels, dets):
    gts = [mod.frame_objects_from_labels(
        [obj_cls(**o) for o in objs], "Car", ("Van",)) for objs in labels]
    ds = [mod.FrameObjects(b2, b3, sc, np.zeros(len(sc), int),
                           np.zeros(len(sc))) for b2, b3, sc in dets]
    return gts, ds


@pytest.mark.parametrize("n_points", [40, 11])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
@pytest.mark.parametrize("metric", ["2d", "bev", "3d"])
def test_evaluate_matches(frames, metric, thresh, n_points):
    labels, dets = frames
    gt_t, det_t = _package_frames(t_eval, TObject, labels, dets)
    gt_j, det_j = _package_frames(j_eval, JObject, labels, dets)
    # The frames hold ignored gts (Vans, hard ones) and DontCare regions.
    assert any(g.cls_ignored.any() for g in gt_t)
    assert any(len(g.dontcare) for g in gt_t)
    ours = t_eval.evaluate(gt_t, det_t, metric=metric, iou_thresh=thresh,
                           n_points=n_points)
    theirs = j_eval.evaluate(gt_j, det_j, metric=metric, iou_thresh=thresh,
                             n_points=n_points)
    assert ours == theirs
    assert min(theirs.values()) > 0          # every difficulty scores


def test_rotated_and_3d_iou_match():
    rng = np.random.RandomState(1)
    a = np.concatenate([rng.uniform(-5, 5, (40, 1)), rng.uniform(1, 2, (40, 1)),
                        rng.uniform(5, 15, (40, 1)), rng.uniform(1, 2, (40, 3)),
                        rng.uniform(-3, 3, (40, 1))], -1)
    b = a[rng.permutation(40)[:25]] + rng.randn(25, 7) * 0.5
    bev = [0, 2, 4, 5, 6]
    ours = t_eval.rotated_iou_bev(a[:, bev], b[:, bev])
    theirs = j_eval.rotated_iou_bev(a[:, bev], b[:, bev])
    assert (theirs > 0).sum() > 10
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(t_eval.iou_3d(a, b), j_eval.iou_3d(a, b))
    np.testing.assert_array_equal(
        t_eval.bev_corners(*a[:, [0, 2, 4, 5, 6]].T),
        j_eval.bev_corners(*a[:, [0, 2, 4, 5, 6]].T))


def test_frame_objects_from_outputs_matches():
    """The same padded numbers as the port's tensors and as the JAX
    package's arrays, two classes, some slots invalid: equal frames,
    for all classes together and per class."""
    rng = np.random.RandomState(2)
    b, d, g = 3, 6, 5
    fields = dict(
        box_left=rng.uniform(0, 500, (b, d, 4)).astype(np.float32),
        box_right=rng.uniform(0, 500, (b, d, 4)).astype(np.float32),
        score=rng.uniform(0, 1, (b, d)).astype(np.float32),
        cls=rng.randint(1, 3, (b, d)).astype(np.int32),
        dims=rng.uniform(1, 4, (b, d, 3)).astype(np.float32),
        alpha=rng.uniform(-3, 3, (b, d)).astype(np.float32),
        kpt_u=rng.uniform(0, 500, (b, d)).astype(np.float32),
        kpt_type=rng.randint(0, 4, (b, d)).astype(np.int32),
        kpt_prob=rng.uniform(0, 1, (b, d)).astype(np.float32),
        border_u=rng.uniform(0, 500, (b, d, 2)).astype(np.float32),
        valid=rng.rand(b, d) < 0.6)
    pos = rng.uniform(-10, 40, (b, d, 3)).astype(np.float32)
    ry = rng.uniform(-3, 3, (b, d)).astype(np.float32)
    zs = np.zeros((b, d), np.float32)
    gt = {k: np.zeros((b, g) + s, dt) for k, s, dt in (
        ("left", (4,), np.float32), ("right", (4,), np.float32),
        ("cls", (), np.int32), ("dims", (3,), np.float32),
        ("alpha", (), np.float32), ("kpt_u", (), np.float32),
        ("kpt_type", (), np.int32), ("kpt_visible", (), bool),
        ("border_u", (2,), np.float32), ("valid", (), bool),
        ("location", (3,), np.float32), ("ry", (), np.float32),
        ("ignore", (), bool))}
    gt["left"][:] = rng.uniform(0, 500, (b, g, 4))
    gt["cls"][:] = rng.randint(1, 3, (b, g))
    gt["dims"][:] = rng.uniform(1, 4, (b, g, 3))
    gt["location"][:] = rng.uniform(-10, 40, (b, g, 3))
    gt["ry"][:] = rng.uniform(-3, 3, (b, g))
    gt["valid"][:] = rng.rand(b, g) < 0.7
    theirs_out = JDetections3D(JDetections(**fields), pos, ry, zs, zs)
    ours_out = TDetections3D(
        TDetections(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        torch.from_numpy(pos), torch.from_numpy(ry), torch.from_numpy(zs),
        torch.from_numpy(zs))
    assert TGroundTruth._fields == JGroundTruth._fields
    for cls_id in (None, 1, 2):
        ours = t_eval.frame_objects_from_outputs(
            ours_out, TGroundTruth(**{k: torch.from_numpy(v)
                                      for k, v in gt.items()}), b, cls_id)
        theirs = j_eval.frame_objects_from_outputs(
            theirs_out, JGroundTruth(**gt), b, cls_id)
        for side_t, side_j in zip(ours, theirs):
            assert len(side_t) == len(side_j) == b
            for ft, fj in zip(side_t, side_j):
                for name in ("box2d", "box3d", "score", "occlusion",
                             "truncation", "cls_ignored", "dontcare"):
                    x, y = getattr(ft, name), getattr(fj, name)
                    assert x.dtype == y.dtype, name
                    np.testing.assert_array_equal(x, y, err_msg=name)
        assert sum(len(f.score) for f in ours[1]) > 0


def test_write_result_file_bytes_match(tmp_path):
    rng = np.random.RandomState(3)
    n = 7
    args = (["Car", "Van", "Car", "Car", "Pedestrian", "Car", "Truck"],
            rng.uniform(0, 1200, (n, 4)), rng.uniform(1, 4, (n, 3)),
            rng.uniform(-20, 60, (n, 3)), rng.uniform(-3.2, 3.2, n),
            rng.uniform(-3.2, 3.2, n), rng.uniform(0, 1, n))
    t_eval.write_result_file(str(tmp_path / "t" / "000001.txt"), *args)
    j_eval.write_result_file(str(tmp_path / "j" / "000001.txt"), *args)
    ours = (tmp_path / "t" / "000001.txt").read_bytes()
    assert ours == (tmp_path / "j" / "000001.txt").read_bytes()
    assert len(ours.splitlines()) == n
    back_t = t_eval.read_result_file(str(tmp_path / "t" / "000001.txt"))
    back_j = j_eval.read_result_file(str(tmp_path / "j" / "000001.txt"))
    np.testing.assert_array_equal(back_t.box3d, back_j.box3d)
    np.testing.assert_array_equal(back_t.score, back_j.score)
