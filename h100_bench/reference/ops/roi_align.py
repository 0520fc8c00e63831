"""FPN level routing and the atlas RoIAlign (port of
``stereo_rcnn_tpu.ops.roi_align``).

:func:`multilevel_roi_align` is what the JAX package leaves to XLA (the
``Config()`` default ``rcnn.roi_align_impl="xla"``): plain torch here, on
every device.  Its semantics differ from the fused kernels' (K1, K4),
which clamp samples to a window: here a sample more than 1 px outside its
level gives zero and every other sample is clamped to the level.  Its
gradient is torch autograd's, a scatter-add through the gather, as XLA's.
"""

from __future__ import annotations

from typing import Sequence

import torch


def fpn_level_assignment(rois: torch.Tensor, num_levels: int,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4,
                         min_level: int = 2) -> torch.Tensor:
    """Per-roi FPN level ``floor(4 + log2(sqrt(wh) / 224))`` as an offset
    from P``min_level``, clamped to ``[0, num_levels - 1]`` (int64)."""
    w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-6)
    h = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-6)
    k = torch.floor(canonical_level +
                    torch.log2(torch.sqrt(w * h) / canonical_scale))
    return torch.clamp(k - min_level, 0, num_levels - 1).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], output_size: int,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign over an FPN pyramid with per-roi level routing.

    feats: levels ``[B, H_l, W_l, C]`` (or ``[H_l, W_l, C]`` with rois
    ``[R, 4]``), finest first; rois ``[B, R, 4]`` xyxy in image
    coordinates.  Returns ``[B, R, P, P, C]`` (or ``[R, P, P, C]``) in the
    features' dtype: the bilinear fractions are cast to it, and the four
    weighted taps, the out-of-bounds zeroing and the bin mean run in it,
    as in the JAX package.
    """
    squeeze = rois.dim() == 2
    if squeeze:
        feats = [f[None] for f in feats]
        rois = rois[None]
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    p, s = output_size, sampling_ratio
    ps = p * s
    dtype = feats[0].dtype
    dev = rois.device

    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    sizes = [h * w for h, w in shapes]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    atlas = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1)

    levels = fpn_level_assignment(rois, len(feats))          # [B, R]
    # One small table per call: each host-to-device copy syncs the stream.
    table = torch.tensor([[h, w, 1.0 / st] for (h, w), st
                          in zip(shapes, strides)], dtype=torch.float32,
                         device=dev)[levels]
    lvl_h, lvl_w, lvl_scale = table.unbind(-1)
    lvl_off = torch.tensor(offsets, device=dev)[levels]      # [B, R]

    scaled = rois * lvl_scale[..., None]
    x1, y1 = scaled[..., 0], scaled[..., 1]
    roi_w = torch.clamp(scaled[..., 2] - x1, min=1.0)
    roi_h = torch.clamp(scaled[..., 3] - y1, min=1.0)

    grid = (torch.arange(ps, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[..., None] + grid * (roi_h / p)[..., None]       # [B, R, PS]
    xs = x1[..., None] + grid * (roi_w / p)[..., None]
    h_ = lvl_h[..., None]
    w_ = lvl_w[..., None]
    # Samples more than 1 px outside the level give zero; the others are
    # clamped to it.
    oob_y = (ys < -1.0) | (ys > h_)
    oob_x = (xs < -1.0) | (xs > w_)
    ys = torch.minimum(torch.clamp(ys, min=0.0), h_ - 1.0)
    xs = torch.minimum(torch.clamp(xs, min=0.0), w_ - 1.0)

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1i = torch.minimum(y0 + 1, h_ - 1.0)
    x1i = torch.minimum(x0 + 1, w_ - 1.0)
    ly = (ys - y0).to(dtype)
    lx = (xs - x0).to(dtype)
    hy = 1.0 - ly
    hx = 1.0 - lx

    row_w = lvl_w.long()[..., None, None]                    # [B, R, 1, 1]
    base = (lvl_off + torch.arange(b, device=dev)[:, None] *
            sum(sizes))[..., None, None]
    flat_atlas = atlas.reshape(-1, c)

    def gather(yi, xi):
        idx = (base + yi.long()[..., :, None] * row_w +
               xi.long()[..., None, :])                      # [B, R, PS, PS]
        return flat_atlas[idx.reshape(-1)].reshape(b, r, ps, ps, c)

    wy, wly = hy[..., :, None], ly[..., :, None]
    wx, wlx = hx[..., None, :], lx[..., None, :]
    val = (gather(y0, x0) * (wy * wx)[..., None] +
           gather(y0, x1i) * (wy * wlx)[..., None] +
           gather(y1i, x0) * (wly * wx)[..., None] +
           gather(y1i, x1i) * (wly * wlx)[..., None])
    zero = (oob_y[..., :, None] | oob_x[..., None, :])[..., None]
    val = torch.where(zero, torch.zeros((), dtype=dtype, device=dev), val)
    out = val.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))
    return out[0] if squeeze else out


def roi_align(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """Single-level RoIAlign (feat ``[H, W, C]``, rois ``[R, 4]`` in image
    coordinates scaled by ``spatial_scale``): every roi on this level."""
    stride = int(round(1.0 / spatial_scale))
    return multilevel_roi_align([feat], rois, [stride], output_size,
                                sampling_ratio)
