"""2D box utilities and the stereo paired-box coder (torch).

Port of ``stereo_rcnn_tpu.geometry.boxes``: the same functions, names and
``off`` box-width convention (``off=1`` is the reference's legacy "+1"
widths, ``Config.box_off``), including the legacy decode asymmetry
(``x2 = ctr + 0.5 * w`` with no ``- 1``).  Boxes are ``[..., 4]`` xyxy.
"""

from __future__ import annotations

import torch

# Clamp on log-space size deltas at decode time.
_MAX_DELTA_WH = 4.0


def box_area(boxes: torch.Tensor, off: float = 0.0) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0] + off, min=0.0) *
            torch.clamp(boxes[..., 3] - boxes[..., 1] + off, min=0.0))


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                 off: float = 0.0) -> torch.Tensor:
    """IoU matrix ``[..., N, M]`` (leading batch dims broadcast)."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (box_area(boxes_a, off)[..., :, None] +
             box_area(boxes_b, off)[..., None, :] - inter)
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                       torch.zeros_like(inter))


def union_box(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Union box of an aligned L/R pair (paired NMS)."""
    return torch.cat([torch.minimum(left[..., :2], right[..., :2]),
                      torch.maximum(left[..., 2:4], right[..., 2:4])], dim=-1)


def clip_boxes(boxes: torch.Tensor, im_h, im_w,
               off: float = 0.0) -> torch.Tensor:
    """Clip to image bounds (legacy clips to ``size - 1``)."""
    x1 = torch.clamp(boxes[..., 0], 0.0, im_w - off)
    y1 = torch.clamp(boxes[..., 1], 0.0, im_h - off)
    x2 = torch.clamp(boxes[..., 2], 0.0, im_w - off)
    y2 = torch.clamp(boxes[..., 3], 0.0, im_h - off)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor, off: float = 0.0) -> torch.Tensor:
    wh = boxes[..., 2:4] - boxes[..., 0:2] + off
    c = boxes[..., 0:2] + 0.5 * wh
    return torch.cat([c, wh], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    half = 0.5 * boxes[..., 2:4]
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def encode_stereo_boxes(anchors: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor,
                        off: float = 0.0) -> torch.Tensor:
    """[..., 4] anchors + left/right boxes -> [..., 6] deltas
    ``[tx, ty, tw, th, tx_r, tw_r]``."""
    a = xyxy_to_cxcywh(anchors, off)
    l = xyxy_to_cxcywh(left, off)
    r = xyxy_to_cxcywh(right, off)
    aw = torch.clamp(a[..., 2], min=1e-6)
    ah = torch.clamp(a[..., 3], min=1e-6)
    tx = (l[..., 0] - a[..., 0]) / aw
    ty = (l[..., 1] - a[..., 1]) / ah
    tw = torch.log(torch.clamp(l[..., 2], min=1e-6) / aw)
    th = torch.log(torch.clamp(l[..., 3], min=1e-6) / ah)
    tx_r = (r[..., 0] - a[..., 0]) / aw
    tw_r = torch.log(torch.clamp(r[..., 2], min=1e-6) / aw)
    return torch.stack([tx, ty, tw, th, tx_r, tw_r], dim=-1)


def decode_stereo_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                        off: float = 0.0):
    """Inverse of :func:`encode_stereo_boxes` -> ``(left, right)`` xyxy; the
    right box shares the decoded left (y, h)."""
    a = xyxy_to_cxcywh(anchors, off)
    aw, ah = a[..., 2], a[..., 3]
    cx = a[..., 0] + deltas[..., 0] * aw
    cy = a[..., 1] + deltas[..., 1] * ah
    w = aw * torch.exp(torch.clamp(deltas[..., 2], -_MAX_DELTA_WH,
                                   _MAX_DELTA_WH))
    h = ah * torch.exp(torch.clamp(deltas[..., 3], -_MAX_DELTA_WH,
                                   _MAX_DELTA_WH))
    cx_r = a[..., 0] + deltas[..., 4] * aw
    w_r = aw * torch.exp(torch.clamp(deltas[..., 5], -_MAX_DELTA_WH,
                                     _MAX_DELTA_WH))
    left = cxcywh_to_xyxy(torch.stack([cx, cy, w, h], dim=-1))
    right = cxcywh_to_xyxy(torch.stack([cx_r, cy, w_r, h], dim=-1))
    return left, right


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor,
                 off: float = 0.0) -> torch.Tensor:
    """Plain 4-tuple Faster R-CNN encoding ``[tx, ty, tw, th]``."""
    return encode_stereo_boxes(anchors, gt, gt, off)[..., :4]


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 off: float = 0.0) -> torch.Tensor:
    """Inverse of :func:`encode_boxes` -> xyxy [..., 4]."""
    pad = torch.stack([deltas[..., 0], deltas[..., 2]], dim=-1)
    left, _ = decode_stereo_boxes(anchors, torch.cat([deltas, pad], dim=-1),
                                  off)
    return left
