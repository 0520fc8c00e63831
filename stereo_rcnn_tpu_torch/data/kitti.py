"""KITTI object dataset: labels, calibration and stereo targets (numpy).

A copy of ``stereo_rcnn_tpu.data.kitti``, which cannot be imported without
JAX: the object record and its label-file parser, the camera-frame corner
geometry, the stereo annotation derived from one object (right box
through P3, perspective and boundary keypoints), the packing of a frame's
annotations into the fixed-shape ``train.targets.GroundTruth``, and the
filesystem reader of a KITTI split (:class:`KittiDataset`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from stereo_rcnn_tpu_torch.config import DataConfig
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib, read_kitti_calib

# Object-frame bottom-corner template — MUST match geometry.projection.
_CX = np.array([0.5, 0.5, -0.5, -0.5])   # x_o in units of l
_CZ = np.array([0.5, -0.5, -0.5, 0.5])   # z_o in units of w


@dataclasses.dataclass
class KittiObject:
    type: str
    truncation: float
    occlusion: int
    alpha: float
    box: np.ndarray          # [4] left-image xyxy
    dims: np.ndarray         # [3] (h, w, l)
    location: np.ndarray     # [3] bottom-center (x, y, z)
    ry: float


def parse_label_file(path: str) -> List[KittiObject]:
    objs = []
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if len(p) < 15:
                continue
            objs.append(KittiObject(
                type=p[0], truncation=float(p[1]), occlusion=int(float(p[2])),
                alpha=float(p[3]),
                box=np.array([float(x) for x in p[4:8]], np.float32),
                dims=np.array([float(x) for x in p[8:11]], np.float32),
                location=np.array([float(x) for x in p[11:14]], np.float32),
                ry=float(p[14]),
            ))
    return objs


def _bottom_corners_cam(loc: np.ndarray, dims: np.ndarray,
                        ry: float) -> np.ndarray:
    """[4, 3] bottom corners in camera frame (order = projection module)."""
    h, w, l = dims
    xo = _CX * l
    zo = _CZ * w
    c, s = np.cos(ry), np.sin(ry)
    x = loc[0] + c * xo + s * zo
    y = np.full(4, loc[1])
    z = loc[2] - s * xo + c * zo
    return np.stack([x, y, z], axis=-1)


def _all_corners_cam(loc, dims, ry) -> np.ndarray:
    bottom = _bottom_corners_cam(loc, dims, ry)
    top = bottom.copy()
    top[:, 1] -= dims[0]
    return np.concatenate([bottom, top], axis=0)          # [8, 3]


def _project_np(pts: np.ndarray, calib: StereoCalib,
                right: bool = False) -> np.ndarray:
    f = float(calib.f)
    cu, cv = float(calib.cu), float(calib.cv)
    off = float(calib.tx2) - (float(calib.baseline) if right else 0.0)
    z = np.maximum(pts[:, 2], 1e-3)
    u = cu + f * (pts[:, 0] + off) / z
    v = cv + f * pts[:, 1] / z
    return np.stack([u, v], axis=-1)


@dataclasses.dataclass
class StereoAnnotation:
    """Derived per-object stereo targets (image coordinates of the ORIGINAL
    resolution; scale afterwards)."""

    cls: int
    box_left: np.ndarray
    box_right: np.ndarray
    dims: np.ndarray
    alpha: float
    kpt_u: float
    kpt_type: int
    kpt_visible: bool
    border_u: np.ndarray     # [2]
    ignore: bool
    location: np.ndarray = None  # [3] 3D bottom-center (x, y, z) metres
    ry: float = 0.0


def derive_stereo_annotation(obj: KittiObject, calib: StereoCalib,
                             im_w: float, cls_id: int,
                             ignore: bool = False) -> StereoAnnotation:
    """Right box via P3 projection; perspective/boundary keypoints.

    Reference: kitti.py gt_roidb right-box derivation + infer_boundary.
    """
    corners = _all_corners_cam(obj.location, obj.dims, obj.ry)
    uv_l = _project_np(corners, calib)
    uv_r = _project_np(corners, calib, right=True)

    # Left box: use the LABELLED 2D box (human-drawn, truncation-aware);
    # right box: projected 3D box clipped to the image.
    box_r = np.array([uv_r[:, 0].min(), uv_r[:, 1].min(),
                      uv_r[:, 0].max(), uv_r[:, 1].max()], np.float32)
    box_r[0] = np.clip(box_r[0], 0, im_w - 1)
    box_r[2] = np.clip(box_r[2], 0, im_w - 1)
    # Share the labelled vertical extent (rectified stereo).
    box_r[1], box_r[3] = obj.box[1], obj.box[3]

    # Perspective keypoint: nearest bottom corner's vertical edge.
    z_bottom = corners[:4, 2]
    kpt_type = int(np.argmin(z_bottom))
    kpt_u = float(uv_l[kpt_type, 0])
    kpt_visible = bool(obj.box[0] - 2 <= kpt_u <= obj.box[2] + 2)

    # Boundary keypoints: leftmost/rightmost visible extent on the object —
    # the projected box clipped against the labelled (truncated) box.
    border = np.array([
        max(uv_l[:, 0].min(), obj.box[0]),
        min(uv_l[:, 0].max(), obj.box[2]),
    ], np.float32)

    return StereoAnnotation(
        cls=cls_id, box_left=obj.box.astype(np.float32), box_right=box_r,
        dims=obj.dims, alpha=obj.alpha, kpt_u=kpt_u, kpt_type=kpt_type,
        kpt_visible=kpt_visible, border_u=border, ignore=ignore,
        location=obj.location.astype(np.float32), ry=obj.ry)


def annotations_for_frame(objs: Sequence[KittiObject], calib: StereoCalib,
                          im_w: float,
                          cfg: DataConfig) -> List[StereoAnnotation]:
    out = []
    for o in objs:
        if o.type in cfg.classes:
            cls_id = cfg.classes.index(o.type)
            if cls_id == 0:
                continue
            out.append(derive_stereo_annotation(o, calib, im_w, cls_id))
        elif o.type in cfg.ignore_types:
            out.append(derive_stereo_annotation(o, calib, im_w, 0,
                                                ignore=True))
    return out


def pack_ground_truth(annos: Sequence[StereoAnnotation], max_gt: int,
                      scale: float = 1.0):
    """Pad/scale annotations into a numpy-leaved
    :class:`~stereo_rcnn_tpu_torch.train.targets.GroundTruth`.

    Real objects come first (``valid=True``); ignore regions (DontCare /
    unlabeled-vehicle types) fill remaining slots with ``ignore=True`` so
    target assignment can exclude them from negative sampling.  3D
    location/ry ride along in METRIC units (only image-plane fields are
    scaled)."""
    from stereo_rcnn_tpu_torch.train.targets import zeros_ground_truth
    real = [a for a in annos if not a.ignore][:max_gt]
    ign = [a for a in annos if a.ignore][:max_gt - len(real)]
    gt = zeros_ground_truth(max_gt)
    for i, a in enumerate(real + ign):
        gt.left[i] = a.box_left * scale
        gt.right[i] = a.box_right * scale
        gt.cls[i] = a.cls
        gt.dims[i] = a.dims
        gt.alpha[i] = a.alpha
        gt.kpt_u[i] = a.kpt_u * scale
        gt.kpt_type[i] = a.kpt_type
        gt.kpt_visible[i] = a.kpt_visible
        gt.border_u[i] = a.border_u * scale
        gt.valid[i] = not a.ignore
        if a.location is not None:
            gt.location[i] = a.location
        gt.ry[i] = a.ry
        gt.ignore[i] = a.ignore
    return gt


class KittiDataset:
    """Filesystem-backed KITTI object split (left and right images).

    Layout (standard KITTI object): ``<root>/training/{image_2, image_3,
    label_2, calib}/<id>.{png,txt}``.
    """

    def __init__(self, cfg: DataConfig, split_dir: str = "training",
                 ids: Optional[Sequence[str]] = None):
        self.cfg = cfg
        self.root = os.path.join(cfg.kitti_root, split_dir)
        if ids is None:
            label_dir = os.path.join(self.root, "label_2")
            ids = sorted(os.path.splitext(f)[0]
                         for f in os.listdir(label_dir)) \
                if os.path.isdir(label_dir) else []
        self.ids = list(ids)

    def __len__(self):
        return len(self.ids)

    def paths(self, idx: int):
        i = self.ids[idx]
        return {
            "left": os.path.join(self.root, "image_2", f"{i}.png"),
            "right": os.path.join(self.root, "image_3", f"{i}.png"),
            "label": os.path.join(self.root, "label_2", f"{i}.txt"),
            "calib": os.path.join(self.root, "calib", f"{i}.txt"),
        }

    def load_annotation(self, idx: int, im_w: float):
        p = self.paths(idx)
        calib = read_kitti_calib(p["calib"])
        objs = parse_label_file(p["label"])
        return annotations_for_frame(objs, calib, im_w, self.cfg), calib
