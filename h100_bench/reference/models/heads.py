"""Second-stage heads: class / stereo box / dims+viewpoint, and keypoints.

Port of ``stereo_rcnn_tpu.models.heads`` with the upstream parameter names
(``RCNN_fc6`` .. ``RCNN_dim_orien_pred``, ``RCNN_kpts_*``).  ``RCNN_fc6``
keeps the upstream layout: its input is the pooled ``[R, 2C, P, P]``
flattened channel-major, which is the layout ``convert/stereo_import.py``
``_fc6`` permutes from.  Layers compute in the input's dtype; outputs are
float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.models.resnet_fpn import Conv2d
from h100_bench.reference.precision import operand


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(operand(x), operand(self.weight.to(x.dtype)),
                        self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            operand(x), operand(self.weight.to(x.dtype)),
            self.bias.to(x.dtype), self.stride, self.padding)


class RCNNOutputs(NamedTuple):
    cls_logits: torch.Tensor      # [R, num_classes]
    box_deltas: torch.Tensor      # [R, num_classes, 6] stereo 6-tuple
    dims: torch.Tensor            # [R, num_classes, 3] (dh, dw, dl) vs mean
    orien: torch.Tensor           # [R, num_classes, 2] (sin a, cos a)


class RCNNHead(nn.Module):
    def __init__(self, in_dim: int, pool: int = 7, num_classes: int = 2,
                 fc_dim: int = 2048):
        super().__init__()
        self.num_classes = num_classes
        self.RCNN_fc6 = Linear(2 * in_dim * pool * pool, fc_dim)
        self.RCNN_fc7 = Linear(fc_dim, fc_dim)
        self.RCNN_cls_score = Linear(fc_dim, num_classes)
        self.RCNN_bbox_pred = Linear(fc_dim, num_classes * 6)
        self.RCNN_dim_orien_pred = Linear(fc_dim, num_classes * 5)

    def forward(self, pooled_concat: torch.Tensor,
                dtype: torch.dtype) -> RCNNOutputs:
        """pooled_concat: [R, P, P, 2C] NHWC (left || right channels)."""
        r = pooled_concat.shape[0]
        x = pooled_concat.to(dtype).permute(0, 3, 1, 2).reshape(r, -1)
        x = F.relu(self.RCNN_fc6(x))
        x = F.relu(self.RCNN_fc7(x))
        k = self.num_classes
        dim_orien = self.RCNN_dim_orien_pred(x).reshape(r, k, 5).float()
        return RCNNOutputs(
            cls_logits=self.RCNN_cls_score(x).float(),
            box_deltas=self.RCNN_bbox_pred(x).reshape(r, k, 6).float(),
            dims=dim_orien[..., :3],
            orien=dim_orien[..., 3:])


class KeypointHead(nn.Module):
    """Six ``grid``-bin horizontal distributions per roi: channels 0..3 the
    perspective keypoint per corner, 4..5 the visible boundaries."""

    def __init__(self, in_dim: int, conv_dim: int = 256,
                 num_channels: int = 6):
        super().__init__()
        self.RCNN_kpts_conv1 = Conv2d(in_dim, conv_dim, 3, padding=1)
        self.RCNN_kpts_conv2 = Conv2d(conv_dim, conv_dim, 3, padding=1)
        self.RCNN_kpts_deconv = ConvTranspose2d(conv_dim, conv_dim, 4,
                                                stride=2, padding=1)
        self.RCNN_kpts_score = Conv2d(conv_dim, num_channels, 1)

    def forward(self, pooled_left: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """pooled_left [R, Pk, Pk, C] NHWC -> logits [R, 6, G] float32."""
        x = pooled_left.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.RCNN_kpts_conv1(x))
        x = F.relu(self.RCNN_kpts_conv2(x))
        x = F.relu(self.RCNN_kpts_deconv(x))
        x = self.RCNN_kpts_score(x)                  # [R, 6, G, G]
        # Marginalise over rows (v) -> 1-D u distributions.
        return x.sum(dim=2).float()
