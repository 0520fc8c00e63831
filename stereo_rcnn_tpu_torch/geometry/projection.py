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


def box2d_from_3d(center, dims_hwl, ry, calib,
                  right: bool = False) -> torch.Tensor:
    """Tight xyxy box [..., 4] of the projected 3D box (how the right GT
    box is derived: the pose projected through P3)."""
    uv = project_box3d(center, dims_hwl, ry, calib, right=right)
    return torch.cat([uv.amin(dim=-2), uv.amax(dim=-2)], dim=-1)


def perspective_keypoints(center, dims_hwl, ry, calib) -> torch.Tensor:
    """u [..., 4] of the four vertical-edge keypoints in the left image,
    indexed by bottom corner k."""
    return project_box3d(center, dims_hwl, ry, calib)[..., :4, 0]


def visible_keypoint_index(center: torch.Tensor,
                           ry: torch.Tensor) -> torch.Tensor:
    """Index k of the nearest vertical edge in depth (the perspective
    keypoint the solver uses); the box's size does not change it."""
    corners = box3d_corners(center, torch.ones_like(center), ry)
    return torch.argmin(corners[..., :4, 2], dim=-1)


def viewpoint_alpha(center: torch.Tensor, ry: torch.Tensor) -> torch.Tensor:
    """KITTI observation angle alpha = ry - atan2(x, z)."""
    return ry - torch.atan2(center[..., 0], center[..., 2])


def ry_from_alpha(alpha: torch.Tensor, x: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    return alpha + torch.atan2(x, z)
