"""ResNet + FPN backbone (torch).

Port of ``stereo_rcnn_tpu.models.resnet_fpn``: caffe variant (stride on
the first 1x1 conv), a stem max-pool that pads with -inf, bilinear
top-down upsampling with ``align_corners=False``, and P6 = P5 subsampled
by 2.  Three norms, as in the JAX package:

* ``"frozen"``: BN folded into a fixed per-channel ``x * scale + bias``
  (buffers); the stem and the first ``frozen_stages`` stages get no
  gradient (the reference's FIXED_BLOCKS);
* ``"affine"``: the same module with ``scale``/``bias`` as parameters,
  ``bn3``'s scale zero-initialised (zero-gamma residual branches);
* ``"group"``: GroupNorm with ``min(32, C)`` groups, flax's epsilon 1e-6
  and its statistics in float32.

``remat`` recomputes each bottleneck in the backward pass
(``torch.utils.checkpoint``), as ``nn.remat`` does in the JAX package.

Parameter names are the upstream Stereo R-CNN ``state_dict`` names
(``RCNN_layer0`` .. ``RCNN_layer4``, ``RCNN_toplayer``, ``RCNN_latlayer*``,
``RCNN_smooth*``); a frozen or affine BN holds ``scale`` and ``bias`` in
place of BatchNorm2d's four, and a GroupNorm site holds its affine under
``gn`` (``bn1.gn.weight``), as the flax tree holds ``bn1/gn/scale``.

Weights stay float32; convolutions run in the dtype of their input
(``compute_dtype``).  The backbone takes NHWC images and runs in
``torch.channels_last``, so each level's ``permute(0, 2, 3, 1)`` is a
contiguous NHWC view.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from h100_bench.reference.precision import operand

STAGE_BLOCKS = {10: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(
            operand(x), operand(self.weight.to(x.dtype)), bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm folded into a per-channel ``scale``/``bias``: fixed
    buffers (identity at init), or parameters when ``trainable`` (the
    "affine" norm; ``zero_init`` starts the scale at 0)."""

    def __init__(self, features: int, trainable: bool = False,
                 zero_init: bool = False):
        super().__init__()
        scale = (torch.zeros if zero_init else torch.ones)(features)
        bias = torch.zeros(features)
        if trainable:
            self.scale = nn.Parameter(scale)
            self.bias = nn.Parameter(bias)
        else:
            self.register_buffer("scale", scale)
            self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x * self.scale.to(x.dtype).view(shape) +
                self.bias.to(x.dtype).view(shape))


class GroupNorm32(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, C))``: float32 statistics
    with flax's one-pass variance ``E[x^2] - E[x]^2`` (clamped at 0),
    epsilon 1e-6, the result cast back to the input's dtype.  Works on the
    NHWC view of a channels-last input, so nothing is transposed."""

    def __init__(self, features: int):
        super().__init__()
        self.gn = nn.GroupNorm(min(32, features), features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = self.gn.num_groups
        xf = x.permute(0, 2, 3, 1).float().reshape(n, h * w, g, c // g)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) -
                          mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.gn.eps) * self.gn.weight.view(
            1, 1, g, c // g)
        y = (xf - mean) * mul + self.gn.bias.view(1, 1, g, c // g)
        return y.reshape(n, h, w, c).to(x.dtype).permute(0, 3, 1, 2)


def make_norm(norm: str, features: int, zero_init: bool = False
              ) -> nn.Module:
    """The norm of one site; ``zero_init`` (``bn3``) applies to "affine"."""
    if norm == "group":
        return GroupNorm32(features)
    if norm in ("frozen", "affine"):
        return FrozenBatchNorm(features, trainable=norm == "affine",
                               zero_init=zero_init and norm == "affine")
    raise ValueError(f"backbone.norm: unknown norm {norm!r} (expected "
                     "'frozen', 'affine' or 'group')")


class Bottleneck(nn.Module):
    """Caffe-variant bottleneck: stride on the first 1x1 conv."""

    def __init__(self, cin: int, width: int, stride: int,
                 norm: str = "frozen"):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, stride=stride, bias=False)
        self.bn1 = make_norm(norm, width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = make_norm(norm, width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = make_norm(norm, width * 4, zero_init=True)
        self.downsample = None
        if stride != 1 or cin != width * 4:
            self.downsample = nn.Sequential(
                Conv2d(cin, width * 4, 1, stride=stride, bias=False),
                make_norm(norm, width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idn)


class ResNetFPN(nn.Module):
    """ResNet-{26,50,101,152} + FPN producing P2..P6 (``fpn_dim`` each)."""

    def __init__(self, depth: int = 101, fpn_dim: int = 256,
                 norm: str = "frozen", frozen_stages: int = 1,
                 remat: bool = False, upsample: str = "bilinear"):
        super().__init__()
        if upsample not in ("bilinear", "nearest"):
            raise ValueError(f"backbone.fpn_upsample: unknown mode "
                             f"{upsample!r} (expected 'bilinear' or "
                             "'nearest')")
        self.upsample = upsample
        self.norm = norm
        self.frozen_stages = frozen_stages
        self.remat = remat
        self.RCNN_layer0 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            make_norm(norm, 64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1))
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            STAGE_BLOCKS[depth]), start=1):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, width,
                                         (1 if li == 1 else 2) if b == 0
                                         else 1, norm))
                cin = width * 4
            setattr(self, f"RCNN_layer{li}", nn.Sequential(*blocks))
        n_frozen = min(frozen_stages + 1, 5) if norm == "frozen" else 0
        for li in range(n_frozen):
            getattr(self, f"RCNN_layer{li}").requires_grad_(False)
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
        frozen = self.norm == "frozen"
        x = self.RCNN_layer0(x)
        if frozen and self.frozen_stages >= 0:
            x = x.detach()
        remat = self.remat and torch.is_grad_enabled()
        stages = []
        for li in range(1, 5):
            for block in getattr(self, f"RCNN_layer{li}"):
                x = (torch.utils.checkpoint.checkpoint(
                    block, x, use_reentrant=False) if remat else block(x))
            if frozen and li <= self.frozen_stages:
                x = x.detach()
            stages.append(x)
        c2, c3, c4, c5 = stages
        p5 = self.RCNN_toplayer(c5)
        up = self.upsample
        p4 = _upsample_add(p5, self.RCNN_latlayer1(c4), up)
        p3 = _upsample_add(p4, self.RCNN_latlayer2(c3), up)
        p2 = _upsample_add(p3, self.RCNN_latlayer3(c2), up)
        p4 = self.RCNN_smooth1(p4)
        p3 = self.RCNN_smooth2(p3)
        p2 = self.RCNN_smooth3(p2)
        p6 = p5[:, :, ::2, ::2]
        return tuple(p.contiguous(memory_format=torch.channels_last)
                     .permute(0, 2, 3, 1) for p in (p2, p3, p4, p5, p6))


def _interp_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of one axis of ``F.interpolate(mode=
    "bilinear", align_corners=False)``: output ``o`` samples ``max(0,
    (o + 0.5) * n_in / n_out - 0.5)`` between its two cells, as ATen's
    upsampling kernel computes it."""
    src = ((torch.arange(n_out, device=device, dtype=dtype) + 0.5)
           * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.long()
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = (src - i0)[:, None]
    cells = torch.arange(n_in, device=device)
    # Elementwise, no scatter: at the last cell both taps are i0.
    return ((cells == i0[:, None]) * (1.0 - l1) +
            (cells == i1[:, None]) * l1)


class _UpsampleBilinear(torch.autograd.Function):
    """``F.interpolate(top, size, mode="bilinear", align_corners=False)``
    whose backward is deterministic: ATen's CUDA backward adds each output
    cell's gradient into its four source cells with float atomics, in an
    order that changes from run to run (the training step's gradients then
    differ in their last bits between two runs from one state).  The
    backward here is the transposed interpolation as two matrix products
    in float32 (float64 for float64), ``A_h^T @ g @ A_w``
    (:func:`_interp_matrix`), summed in a fixed order; the forward is
    ATen's, bit for bit."""

    @staticmethod
    def forward(ctx, top, size):
        ctx.in_size = top.shape[2:]
        return F.interpolate(top, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_size, g.shape[2:]
        dt = torch.promote_types(g.dtype, torch.float32)
        a_h = _interp_matrix(h, oh, dt, g.device)
        a_w = _interp_matrix(w, ow, dt, g.device)
        d = torch.matmul(a_h.t(), torch.matmul(g.to(dt), a_w))
        return d.to(g.dtype).contiguous(memory_format=torch.channels_last), \
            None


def _upsample_add(top: torch.Tensor, lateral: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Upsample ``top`` to the lateral's size and add the lateral.
    "bilinear": half-pixel centres (resnet.py ``_upsample_add``), with a
    deterministic backward (:class:`_UpsampleBilinear`); "nearest": every
    cell repeated 2x on both axes, cropped to the lateral's size (the JAX
    package's cheaper option)."""
    h, w = lateral.shape[2:]
    if mode == "bilinear":
        up = _UpsampleBilinear.apply(top, (h, w))
    else:
        up = top.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        up = up[:, :, :h, :w]
    return up + lateral
