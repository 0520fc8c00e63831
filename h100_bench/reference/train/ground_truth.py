"""Ground truth of a rendered scene, packed as the training step takes it:
a frozen copy of the measured program's ``data.kitti`` annotation rules
(``derive_stereo_annotation``, ``annotations_for_frame``,
``pack_ground_truth``).

The left box is the labelled 2D box, the right box the projected 3D box
clipped to the image with the left box's rows; the perspective keypoint
is the nearest bottom corner, the border keypoints the projected box's
extent clipped to the labelled box.  Real objects fill the first slots,
ignore regions the next, padding the rest.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from h100_bench.reference.config import DataConfig
from h100_bench.reference.data.kitti import (KittiObject, _all_corners_cam,
                                             _project_np)
from h100_bench.reference.geometry.calib import StereoCalib
from h100_bench.reference.train.targets import GroundTruth, zeros_ground_truth


def _annotation(obj: KittiObject, calib: StereoCalib, im_w: float,
                cls_id: int, ignore: bool) -> dict:
    corners = _all_corners_cam(obj.location, obj.dims, obj.ry)
    uv_l = _project_np(corners, calib)
    uv_r = _project_np(corners, calib, right=True)
    box_r = np.array([uv_r[:, 0].min(), uv_r[:, 1].min(),
                      uv_r[:, 0].max(), uv_r[:, 1].max()], np.float32)
    box_r[0] = np.clip(box_r[0], 0, im_w - 1)
    box_r[2] = np.clip(box_r[2], 0, im_w - 1)
    box_r[1], box_r[3] = obj.box[1], obj.box[3]
    kpt_type = int(np.argmin(corners[:4, 2]))
    kpt_u = float(uv_l[kpt_type, 0])
    border = np.array([max(uv_l[:, 0].min(), obj.box[0]),
                       min(uv_l[:, 0].max(), obj.box[2])], np.float32)
    return dict(cls=cls_id, left=obj.box.astype(np.float32), right=box_r,
                dims=obj.dims, alpha=obj.alpha, kpt_u=kpt_u,
                kpt_type=kpt_type,
                kpt_visible=bool(obj.box[0] - 2 <= kpt_u <= obj.box[2] + 2),
                border_u=border, ignore=ignore,
                location=obj.location.astype(np.float32), ry=obj.ry)


def annotations(objs: Sequence[KittiObject], calib: StereoCalib,
                im_w: float, cfg: DataConfig) -> List[dict]:
    """One annotation per object of a class or an ignored type."""
    out = []
    for o in objs:
        if o.type in cfg.classes and cfg.classes.index(o.type) > 0:
            out.append(_annotation(o, calib, im_w, cfg.classes.index(o.type),
                                   False))
        elif o.type in cfg.ignore_types:
            out.append(_annotation(o, calib, im_w, 0, True))
    return out


def pack_ground_truth(annos: Sequence[dict], max_gt: int) -> GroundTruth:
    """``max_gt`` slots with numpy leaves: real objects first, then ignore
    regions, then padding."""
    real = [a for a in annos if not a["ignore"]][:max_gt]
    ign = [a for a in annos if a["ignore"]][:max_gt - len(real)]
    gt = zeros_ground_truth(max_gt)
    for i, a in enumerate(real + ign):
        for field in ("left", "right", "cls", "dims", "alpha", "kpt_u",
                      "kpt_type", "kpt_visible", "border_u", "location",
                      "ry", "ignore"):
            getattr(gt, field)[i] = a[field]
        gt.valid[i] = not a["ignore"]
    return gt
