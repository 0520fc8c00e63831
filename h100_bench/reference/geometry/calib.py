"""KITTI stereo calibration (numpy).

A copy of ``stereo_rcnn_tpu.geometry.calib``, which cannot be imported
without JAX.  Behavioral reference: ``lib/model/utils/kitti_utils.py`` —
``read_obj_calibration``.  Fields stay numpy scalars on the host;
``inference.broadcast_calib`` turns them into per-image tensors on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StereoCalib(NamedTuple):
    """Minimal pinhole stereo rig (rectified, as in KITTI).

    All fields are scalars (or (3,4) matrices) so a batch of calibs is just a
    stacked pytree.  Units: pixels for f/cu/cv, metres for baseline.
    """

    f: np.ndarray         # focal length (pixels), P2[0, 0]
    cu: np.ndarray        # principal point u, P2[0, 2]
    cv: np.ndarray        # principal point v, P2[1, 2]
    baseline: np.ndarray  # stereo baseline (m): (P2[0,3] - P3[0,3]) / f
    tx2: np.ndarray       # left-cam x offset from reference cam: P2[0,3]/f
    p2: np.ndarray        # (3, 4) left projection
    p3: np.ndarray        # (3, 4) right projection

    def scale(self, factor) -> "StereoCalib":
        """Rescale intrinsics for a resized image (baseline is metric).

        numpy on purpose — runs per frame on the host data path (see
        module docstring).  ``factor`` must be a host scalar."""
        factor = np.float32(factor)
        s = np.stack([factor, factor, np.float32(1.0)])[:, None]
        return StereoCalib(
            f=self.f * factor, cu=self.cu * factor, cv=self.cv * factor,
            baseline=self.baseline, tx2=self.tx2,
            p2=self.p2 * s, p3=self.p3 * s,
        )


def calib_from_p2_p3(p2: np.ndarray, p3: np.ndarray) -> StereoCalib:
    p2 = np.asarray(p2, dtype=np.float32).reshape(3, 4)
    p3 = np.asarray(p3, dtype=np.float32).reshape(3, 4)
    f = p2[0, 0]
    return StereoCalib(
        f=f,
        cu=p2[0, 2],
        cv=p2[1, 2],
        baseline=(p2[0, 3] - p3[0, 3]) / f,
        tx2=p2[0, 3] / f,
        p2=p2,
        p3=p3,
    )


def read_kitti_calib(path: str) -> StereoCalib:
    """Parse a KITTI object-detection calib file (P0..P3, R0_rect, Tr_*)."""
    mats = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, vals = line.split(":", 1)
            mats[key.strip()] = np.fromstring(vals, sep=" ")
    return calib_from_p2_p3(mats["P2"], mats["P3"])


def default_kitti_calib() -> StereoCalib:
    """Nominal KITTI calibration (used by synthetic fixtures and tests)."""
    f, cu, cv, b = 721.5377, 609.5593, 172.854, 0.54
    p2 = np.array([[f, 0, cu, 44.85728], [0, f, cv, 0.2163791],
                   [0, 0, 1, 2.745884e-3]], np.float32)
    p3 = p2.copy()
    p3[0, 3] = p2[0, 3] - f * b
    return calib_from_p2_p3(p2, p3)
