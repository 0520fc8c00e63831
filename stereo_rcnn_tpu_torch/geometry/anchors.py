"""FPN anchor generation (port of ``stereo_rcnn_tpu.geometry.anchors``).

Anchors are built once per image size in numpy and moved to the device;
the order is level-major, then row-major, then ratio — the flatten order
of the RPN head outputs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from stereo_rcnn_tpu_torch.config import AnchorConfig
from stereo_rcnn_tpu_torch.device import resolve_device


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


def level_shapes(image_h: int, image_w: int,
                 strides: Sequence[int]) -> List[Tuple[int, int]]:
    """(H, W) of each pyramid level for a given padded image size."""
    return [(-(-image_h // s), -(-image_w // s)) for s in strides]


def generate_anchors(cfg: AnchorConfig, image_h: int, image_w: int,
                     off: float = 0.0,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """All anchors over all levels, ``[A_total, 4]`` xyxy float32, on
    ``device`` (default: the CUDA card)."""
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
    return torch.from_numpy(np.concatenate(per_level, axis=0)).to(
        resolve_device(device))


def anchors_per_level(cfg: AnchorConfig, image_h: int,
                      image_w: int) -> List[int]:
    """Anchor count of each level, in :func:`generate_anchors`' order."""
    return [fh * fw * cfg.num_anchors_per_cell
            for fh, fw in level_shapes(image_h, image_w, cfg.strides)]
