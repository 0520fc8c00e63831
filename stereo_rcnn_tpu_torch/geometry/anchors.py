"""FPN anchor generation (port of ``stereo_rcnn_tpu.geometry.anchors``).

Anchors are built once per image size in numpy and moved to the device;
the order is level-major, then row-major, then ratio — the flatten order
of the RPN head outputs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from stereo_rcnn_tpu_torch.config import AnchorConfig


def base_anchors(scale: float, ratios: Sequence[float],
                 off: float = 0.0) -> np.ndarray:
    """Anchors centered at (0, 0) with area scale^2 (ratio = h / w); under
    the legacy convention (``off=1``) the half-span is (w - off) / 2."""
    out = []
    for r in ratios:
        w = scale / np.sqrt(r)
        h = scale * np.sqrt(r)
        out.append([-(w - off) / 2.0, -(h - off) / 2.0,
                    (w - off) / 2.0, (h - off) / 2.0])
    return np.asarray(out, dtype=np.float32)


def generate_anchors(cfg: AnchorConfig, image_h: int, image_w: int,
                     off: float = 0.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """All anchors over all levels, ``[A_total, 4]`` xyxy float32."""
    per_level = []
    for stride, scale in zip(cfg.strides, cfg.scales):
        fh, fw = -(-image_h // stride), -(-image_w // stride)
        base = base_anchors(scale, cfg.ratios, off)                # [A, 4]
        sx = np.arange(fw, dtype=np.float32) * stride + (stride - off) / 2.0
        sy = np.arange(fh, dtype=np.float32) * stride + (stride - off) / 2.0
        cx, cy = np.meshgrid(sx, sy)                               # [fh, fw]
        shifts = np.stack([cx, cy, cx, cy], axis=-1)               # [fh, fw, 4]
        anchors = shifts[:, :, None, :] + base[None, None, :, :]
        per_level.append(anchors.reshape(-1, 4))
    return torch.from_numpy(np.concatenate(per_level, axis=0)).to(device)

