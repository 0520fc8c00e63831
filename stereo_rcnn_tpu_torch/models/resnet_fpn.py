"""ResNet + FPN backbone with frozen BatchNorm (torch).

Port of ``stereo_rcnn_tpu.models.resnet_fpn`` for ``norm="frozen"``: caffe
variant (stride on the first 1x1 conv), frozen BN as a fixed per-channel
``x * scale + bias`` (the JAX package's folded constants), a stem max-pool
that pads with -inf, bilinear top-down upsampling with
``align_corners=False``, and P6 = P5 subsampled by 2.

Parameter names are the upstream Stereo R-CNN ``state_dict`` names
(``RCNN_layer0`` .. ``RCNN_layer4``, ``RCNN_toplayer``, ``RCNN_latlayer*``,
``RCNN_smooth*``); a frozen BN holds ``scale`` and ``bias`` buffers in
place of BatchNorm2d's four.

Weights stay float32; convolutions run in the dtype of their input
(``compute_dtype``).  The backbone takes NHWC images and runs in
``torch.channels_last``, so each level's ``permute(0, 2, 3, 1)`` is a
contiguous NHWC view.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {10: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm folded into fixed ``scale``/``bias`` (identity at init)."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x * self.scale.to(x.dtype).view(shape) +
                self.bias.to(x.dtype).view(shape))


class Bottleneck(nn.Module):
    """Caffe-variant bottleneck: stride on the first 1x1 conv."""

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = None
        if stride != 1 or cin != width * 4:
            self.downsample = nn.Sequential(
                Conv2d(cin, width * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idn)


class ResNetFPN(nn.Module):
    """ResNet-{26,50,101,152} + FPN producing P2..P6 (``fpn_dim`` each)."""

    def __init__(self, depth: int = 101, fpn_dim: int = 256):
        super().__init__()
        self.RCNN_layer0 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            FrozenBatchNorm(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1))
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            STAGE_BLOCKS[depth]), start=1):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, width,
                                         (1 if li == 1 else 2) if b == 0
                                         else 1))
                cin = width * 4
            setattr(self, f"RCNN_layer{li}", nn.Sequential(*blocks))
        d = fpn_dim
        self.RCNN_toplayer = Conv2d(2048, d, 1)
        self.RCNN_latlayer1 = Conv2d(1024, d, 1)
        self.RCNN_latlayer2 = Conv2d(512, d, 1)
        self.RCNN_latlayer3 = Conv2d(256, d, 1)
        self.RCNN_smooth1 = Conv2d(d, d, 3, padding=1)
        self.RCNN_smooth2 = Conv2d(d, d, 3, padding=1)
        self.RCNN_smooth3 = Conv2d(d, d, 3, padding=1)

    def forward(self, images: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """images [N, H, W, 3] -> P2..P6 as NHWC views [N, H_l, W_l, C]."""
        x = images.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        c1 = self.RCNN_layer0(x)
        c2 = self.RCNN_layer1(c1)
        c3 = self.RCNN_layer2(c2)
        c4 = self.RCNN_layer3(c3)
        c5 = self.RCNN_layer4(c4)
        p5 = self.RCNN_toplayer(c5)
        p4 = _upsample_add(p5, self.RCNN_latlayer1(c4))
        p3 = _upsample_add(p4, self.RCNN_latlayer2(c3))
        p2 = _upsample_add(p3, self.RCNN_latlayer3(c2))
        p4 = self.RCNN_smooth1(p4)
        p3 = self.RCNN_smooth2(p3)
        p2 = self.RCNN_smooth3(p2)
        p6 = p5[:, :, ::2, ::2]
        return tuple(p.contiguous(memory_format=torch.channels_last)
                     .permute(0, 2, 3, 1) for p in (p2, p3, p4, p5, p6))


def _upsample_add(top: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """Bilinear (half-pixel centres) upsample of ``top`` to the lateral's
    size, plus the lateral (resnet.py ``_upsample_add``)."""
    up = F.interpolate(top, size=lateral.shape[2:], mode="bilinear",
                       align_corners=False)
    return up + lateral
