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

When no gradient is taken and the norm is "frozen" or "affine", the
forward folds each norm into the convolution before it: the weights
``w * scale`` (float32, then cast once to the compute dtype, channels_last)
and the bias, built once per set of weights (:meth:`ResNetFPN.folded`),
and each convolution is followed by one epilogue (bias, residual, ReLU;
``ops.conv_epilogue``, K6 on the card) in place of the norm's broadcast
passes.  A bottleneck's downsample norm adds its bias to ``bn3``'s, and
the FPN's convolutions move their bias into the epilogue, the lateral ones
with the upsampled level as the residual.  Under grad, and for "group",
the forward is the unfolded one.

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

import weakref
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from stereo_rcnn_tpu_torch.ops.conv_epilogue import conv_epilogue
from stereo_rcnn_tpu_torch.ops.cuda_build import traced

STAGE_BLOCKS = {10: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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


class FoldedConv(NamedTuple):
    """A convolution with its norm's scale folded into ``weight`` (the
    compute dtype, channels_last) and the epilogue's float32 ``bias``."""

    weight: torch.Tensor
    bias: torch.Tensor
    stride: Tuple[int, int]
    padding: Tuple[int, int]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution alone: its epilogue is the caller's."""
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


def fold_conv(conv: nn.Conv2d, norm: Optional[FrozenBatchNorm],
              dtype: torch.dtype,
              extra_bias: Optional[torch.Tensor] = None) -> FoldedConv:
    """``conv`` then ``norm`` (None: the conv's own bias) as one
    convolution and a bias: ``w * scale`` per output channel in float32,
    cast once to ``dtype``; ``extra_bias`` is added to the bias.  Reads no
    value: an identity norm folds like any other."""
    w = conv.weight.float()
    if norm is None:
        bias = conv.bias.float()
    else:
        w = w * norm.scale.float()[:, None, None, None]
        bias = norm.bias.float()
    if extra_bias is not None:
        bias = bias + extra_bias.float()
    return FoldedConv(
        w.to(dtype).contiguous(memory_format=torch.channels_last),
        bias.contiguous(), conv.stride, conv.padding)


def fold_bottleneck(block: Bottleneck, dtype: torch.dtype
                    ) -> Tuple[FoldedConv, FoldedConv, FoldedConv,
                               Optional[FoldedConv]]:
    """A bottleneck's three folded convolutions and its downsample's (or
    None); the downsample norm's bias is added to ``bn3``'s, since the
    two branches meet in one epilogue."""
    down = extra = None
    if block.downsample is not None:
        dconv, dnorm = block.downsample
        down = fold_conv(dconv, dnorm, dtype)    # its bias goes unused
        extra = dnorm.bias
    return (fold_conv(block.conv1, block.bn1, dtype),
            fold_conv(block.conv2, block.bn2, dtype),
            fold_conv(block.conv3, block.bn3, dtype, extra), down)


def bottleneck_folded(x: torch.Tensor, sites) -> torch.Tensor:
    """:meth:`Bottleneck.forward` on :func:`fold_bottleneck`'s sites: three
    convolutions and three epilogues, the last with the identity (or the
    downsample convolution) as its residual."""
    s1, s2, s3, down = sites
    y = conv_epilogue(s1(x), s1.bias, relu=True)
    y = conv_epilogue(s2(y), s2.bias, relu=True)
    return conv_epilogue(s3(y), s3.bias, x if down is None else down(x),
                         relu=True)


class FoldedBackbone(NamedTuple):
    """Every folded site of a :class:`ResNetFPN`: the stem, the
    bottlenecks by stage, and the FPN's top, lateral (P4, P3, P2) and
    smoothing (P4, P3, P2) convolutions."""

    stem: FoldedConv
    stages: List[List[tuple]]
    fpn_top: FoldedConv
    fpn_lateral: Tuple[FoldedConv, FoldedConv, FoldedConv]
    fpn_smooth: Tuple[FoldedConv, FoldedConv, FoldedConv]


def _tensor(m: nn.Module, name: str) -> torch.Tensor:
    """``m``'s parameter or buffer ``name``, without ``__getattr__``."""
    t = m._parameters.get(name)
    return m._buffers[name] if t is None else t


class _FoldEntry(NamedTuple):
    """:meth:`ResNetFPN.folded`'s kept build: the device, the dtype and
    each source's address and version; weak references to the sources;
    the folded sites."""

    stamp: tuple
    sources: List[weakref.ref]
    sites: FoldedBackbone


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
        # The folded weights (plain attributes, not in the state_dict); see
        # folded().
        self._fold: Optional[_FoldEntry] = None
        self.fold_builds = 0

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .float() ...: the folded copy of the old weights
        # is dropped at once rather than at the next no-grad forward.
        self._fold = None
        return super()._apply(fn, *args, **kwargs)

    def _fold_sources(self) -> List[torch.Tensor]:
        """Every tensor :meth:`fold` reads, from the live modules (a
        replaced submodule's tensors are its own)."""
        out = []
        for conv, norm in self._norm_sites():
            out += (_tensor(conv, "weight"), _tensor(norm, "scale"),
                    _tensor(norm, "bias"))
        for conv in self._fpn_convs():
            out += (_tensor(conv, "weight"), _tensor(conv, "bias"))
        return out

    # The traversals below read ``_modules`` rather than attributes:
    # folded() walks them on every no-grad call, and nn.Module's
    # ``__getattr__`` would cost it ~3x the host time.
    def _stages(self) -> List[List[Bottleneck]]:
        """The bottlenecks of stages 1 to 4."""
        top = self._modules
        return [list(top[f"RCNN_layer{li}"]._modules.values())
                for li in range(1, 5)]

    def _norm_sites(self):
        """``(conv, norm)`` of the stem and of every bottleneck's
        convolutions (the downsample's after conv3's)."""
        stem = self._modules["RCNN_layer0"]._modules
        yield stem["0"], stem["1"]
        for blocks in self._stages():
            for b in blocks:
                m = b._modules
                yield from ((m["conv1"], m["bn1"]), (m["conv2"], m["bn2"]),
                            (m["conv3"], m["bn3"]))
                if m.get("downsample") is not None:
                    yield tuple(m["downsample"]._modules.values())

    def _fpn_convs(self):
        top = self._modules
        return tuple(top[k] for k in (
            "RCNN_toplayer", "RCNN_latlayer1", "RCNN_latlayer2",
            "RCNN_latlayer3", "RCNN_smooth1", "RCNN_smooth2",
            "RCNN_smooth3"))

    def fold(self, dtype: torch.dtype) -> FoldedBackbone:
        """Every site folded for ``dtype`` (:func:`fold_conv`), computed
        now from the current weights."""
        top, l1, l2, l3, s1, s2, s3 = (fold_conv(c, None, dtype)
                                       for c in self._fpn_convs())
        return FoldedBackbone(
            fold_conv(self.RCNN_layer0[0], self.RCNN_layer0[1], dtype),
            [[fold_bottleneck(b, dtype) for b in blocks]
             for blocks in self._stages()],
            top, (l1, l2, l3), (s1, s2, s3))

    def folded(self, device: torch.device, dtype: torch.dtype
               ) -> FoldedBackbone:
        """:meth:`fold` for ``dtype``, built once per set of weights: kept
        while the device, the dtype, every source tensor (the same object)
        and its ``data_ptr()`` and ``_version`` stay as they were (a
        ``load_state_dict``, in place or with ``assign=True``, a replaced
        submodule, an in-place edit and an optimizer step all change one),
        else rebuilt and counted in ``fold_builds``.  The entry holds weak
        references to the sources, so it keeps no old weight alive."""
        sources = self._fold_sources()
        stamp = (device, dtype, [(t.data_ptr(), t._version)
                                 for t in sources])
        f = self._fold
        if (f is None or f.stamp != stamp
                or any(r() is not t for r, t in zip(f.sources, sources))):
            self._fold = None           # drop the old weights first
            self._fold = _FoldEntry(stamp, [weakref.ref(t) for t in sources],
                                    self.fold(dtype))
            self.fold_builds += 1
        return self._fold.sites

    def forward(self, images: torch.Tensor,
                dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """images [N, H, W, 3] -> P2..P6 as NHWC views [N, H_l, W_l, C]."""
        x = images.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if self.norm != "group" and not torch.is_grad_enabled():
            # Traced (torch.export), the fold is part of the graph and is
            # kept nowhere: the program's weights stay its inputs.
            fb = (self.fold(dtype) if traced(x)
                  else self.folded(x.device, dtype))
            return self._forward_folded(x, fb)
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
        return _levels(*self.fpn(stages))

    def fpn(self, stages):
        """P2..P5 from C2..C5, unfolded."""
        c2, c3, c4, c5 = stages
        p5 = self.RCNN_toplayer(c5)
        up = self.upsample
        p4 = _upsample_add(p5, self.RCNN_latlayer1(c4), up)
        p3 = _upsample_add(p4, self.RCNN_latlayer2(c3), up)
        p2 = _upsample_add(p3, self.RCNN_latlayer3(c2), up)
        p4 = self.RCNN_smooth1(p4)
        p3 = self.RCNN_smooth2(p3)
        p2 = self.RCNN_smooth3(p2)
        return p2, p3, p4, p5

    def _forward_folded(self, x: torch.Tensor,
                        fb: FoldedBackbone) -> Tuple[torch.Tensor, ...]:
        """:meth:`forward` on the folded sites: each convolution followed
        by one epilogue."""
        x = stem_folded(x, fb.stem)
        stages = []
        for blocks in fb.stages:
            for sites in blocks:
                x = bottleneck_folded(x, sites)
            stages.append(x)
        return _levels(*fpn_folded(stages, fb, self.upsample))


def stem_folded(x: torch.Tensor, site: FoldedConv) -> torch.Tensor:
    """``RCNN_layer0`` on its folded site: the convolution, one epilogue
    (bias, ReLU), the max-pool (which pads with -inf)."""
    return F.max_pool2d(conv_epilogue(site(x), site.bias, relu=True), 3, 2,
                        1)


def fpn_folded(stages, fb: FoldedBackbone, mode: str):
    """P2..P5 from C2..C5 on the folded FPN convolutions: each lateral's
    epilogue adds the upsampled level above as its residual."""
    c2, c3, c4, c5 = stages
    p5 = conv_epilogue(fb.fpn_top(c5), fb.fpn_top.bias)
    p = [p5]
    for c, site in zip((c4, c3, c2), fb.fpn_lateral):
        y = site(c)
        up = _upsample(p[-1], y.shape[2:], mode)
        p.append(conv_epilogue(y, site.bias, up.contiguous(
            memory_format=torch.channels_last)))
    p4, p3, p2 = (conv_epilogue(site(q), site.bias)
                  for q, site in zip(p[1:], fb.fpn_smooth))
    return p2, p3, p4, p5


def _levels(p2, p3, p4, p5):
    """P2..P6 (P6 = P5 subsampled by 2) as NHWC views."""
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
    return _upsample(top, lateral.shape[2:], mode) + lateral


def _upsample(top: torch.Tensor, size, mode: str) -> torch.Tensor:
    """``top`` upsampled to ``size`` (:func:`_upsample_add`'s modes)."""
    h, w = size
    if mode == "bilinear":
        return _UpsampleBilinear.apply(top, (h, w))
    up = top.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, :h, :w]
