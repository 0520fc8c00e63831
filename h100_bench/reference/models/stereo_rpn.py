"""Stereo Region Proposal Network (torch).

Port of ``stereo_rcnn_tpu.models.stereo_rpn``: a shared 3x3 conv over
``concat(P_L, P_R)`` per level feeding 1x1 objectness (2 per anchor) and
stereo 6-tuple (6 per anchor) heads, and fixed-shape proposal selection:
decode, clip, min-size filter, pre-NMS top-K, union-box NMS, post-NMS
top-N.  Selection runs on the whole batch at once.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.config import RPNConfig
from h100_bench.reference.geometry.boxes import (clip_boxes,
                                                  decode_stereo_boxes,
                                                  union_box)
from h100_bench.reference.models.resnet_fpn import Conv2d
from h100_bench.reference.ops.nms import nms_indices, top_k_stable


class StereoRPNHead(nn.Module):
    """Shared-across-levels head; upstream names ``RPN_Conv``,
    ``RPN_cls_score`` and ``RPN_bbox_pred``."""

    def __init__(self, in_dim: int, num_anchors: int = 3,
                 conv_dim: int = 512):
        super().__init__()
        self.num_anchors = num_anchors
        self.RPN_Conv = Conv2d(2 * in_dim, conv_dim, 3, padding=1)
        self.RPN_cls_score = Conv2d(conv_dim, num_anchors * 2, 1)
        self.RPN_bbox_pred = Conv2d(conv_dim, num_anchors * 6, 1)

    def forward(self, feats_left: Sequence[torch.Tensor],
                feats_right: Sequence[torch.Tensor]):
        """NHWC levels -> (logits [B, A_total, 2], deltas [B, A_total, 6])
        float32, flattened level-major, row-major, anchor-minor."""
        logits_all, deltas_all = [], []
        for fl, fr in zip(feats_left, feats_right):
            x = torch.cat([fl, fr], dim=-1).permute(0, 3, 1, 2)
            x = F.relu(self.RPN_Conv(x))
            lg = self.RPN_cls_score(x).permute(0, 2, 3, 1)   # [B, H, W, 2A]
            dl = self.RPN_bbox_pred(x).permute(0, 2, 3, 1)   # [B, H, W, 6A]
            b = lg.shape[0]
            logits_all.append(lg.reshape(b, -1, 2))
            deltas_all.append(dl.reshape(b, -1, 6))
        return (torch.cat(logits_all, dim=1).float(),
                torch.cat(deltas_all, dim=1).float())


class Proposals(NamedTuple):
    left: torch.Tensor     # [B, N, 4] left rois, padded
    right: torch.Tensor    # [B, N, 4] aligned right rois
    scores: torch.Tensor   # [B, N] objectness
    valid: torch.Tensor    # [B, N] bool


def take_per_image(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched ``x[b, idx[b]]`` for x [B, N, ...] and idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def select_proposals(logits: torch.Tensor, deltas: torch.Tensor,
                     anchors: torch.Tensor, im_h: int, im_w: int,
                     cfg: RPNConfig, train: bool,
                     off: float = 0.0) -> Proposals:
    """Fixed-shape proposal selection for a batch: logits [B, A, 2],
    deltas [B, A, 6], anchors [A, 4]."""
    pre_n = cfg.train_pre_nms_top_n if train else cfg.test_pre_nms_top_n
    post_n = cfg.train_post_nms_top_n if train else cfg.test_post_nms_top_n

    scores = torch.softmax(logits, dim=-1)[..., 1]            # [B, A]
    left, right = decode_stereo_boxes(anchors, deltas, off)
    left = clip_boxes(left, im_h, im_w, off)
    right = clip_boxes(right, im_h, im_w, off)

    # Min-size filter on the left box (legacy widths are x2 - x1 + 1).
    w = left[..., 2] - left[..., 0] + off
    h = left[..., 3] - left[..., 1] + off
    ok = (w >= cfg.min_size) & (h >= cfg.min_size)
    scores = torch.where(ok, scores, torch.full_like(scores, -1.0))

    top_scores, top_idx = top_k_stable(scores, pre_n)
    left_k = take_per_image(left, top_idx)
    right_k = take_per_image(right, top_idx)
    keep_idx, keep_valid = nms_indices(union_box(left_k, right_k),
                                       top_scores, cfg.nms_thresh, post_n,
                                       valid=top_scores >= 0, off=off)
    return Proposals(left=take_per_image(left_k, keep_idx),
                     right=take_per_image(right_k, keep_idx),
                     scores=take_per_image(top_scores, keep_idx),
                     valid=keep_valid)
