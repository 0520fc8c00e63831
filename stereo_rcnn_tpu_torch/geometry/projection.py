"""3D box geometry: corners and stereo projection (torch).

Port of ``stereo_rcnn_tpu.geometry.projection``.  KITTI camera frame (x
right, y down, z forward); a box is its bottom-center, (h, w, l) and yaw
``ry``.  Corners 0..3 are the bottom face, k + 4 the matching top corner.

``calib`` is a :class:`~stereo_rcnn_tpu_torch.geometry.calib.StereoCalib`
whose fields are numbers or tensors that broadcast against
``points[..., 0]``: the solver passes per-detection ``[N, 1]`` fields.
"""

from __future__ import annotations

import torch

_CORNERS_X = (0.5, 0.5, -0.5, -0.5) * 2
_CORNERS_Z = (0.5, -0.5, -0.5, 0.5) * 2
_CORNERS_Y = (0.0,) * 4 + (-1.0,) * 4


def box3d_corners(center: torch.Tensor, dims_hwl: torch.Tensor,
                  ry: torch.Tensor) -> torch.Tensor:
    """center [..., 3], dims [..., 3] (h, w, l), ry [...] -> [..., 8, 3]."""
    h, w, l = dims_hwl[..., 0], dims_hwl[..., 1], dims_hwl[..., 2]
    # Template scaled with Python constants: no host-to-device copy, which
    # would synchronise the stream inside the solver's loop.
    xo = torch.stack([k * l for k in _CORNERS_X], dim=-1)
    yo = torch.stack([k * h for k in _CORNERS_Y], dim=-1)
    zo = torch.stack([k * w for k in _CORNERS_Z], dim=-1)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x = center[..., 0:1] + c * xo + s * zo
    y = center[..., 1:2] + yo
    z = center[..., 2:3] - s * xo + c * zo
    return torch.stack([x, y, z], dim=-1)


def project(points: torch.Tensor, calib, right: bool = False) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel (u, v) [..., 2]; the right
    camera sits one baseline further along -x."""
    offset = calib.tx2 - (calib.baseline if right else 0.0)
    z = torch.clamp(points[..., 2], min=1e-3)
    u = calib.cu + calib.f * (points[..., 0] + offset) / z
    v = calib.cv + calib.f * points[..., 1] / z
    return torch.stack([u, v], dim=-1)


def project_box3d(center, dims_hwl, ry, calib, right: bool = False):
    """Projected 2D corners [..., 8, 2] of a 3D box."""
    return project(box3d_corners(center, dims_hwl, ry), calib, right=right)
