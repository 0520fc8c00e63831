"""KITTI objects for the renderer (numpy): the object record and the
camera-frame corner geometry, copied from the port's ``data.kitti``."""

from __future__ import annotations

import dataclasses

import numpy as np

from h100_bench.reference.geometry.calib import StereoCalib

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
