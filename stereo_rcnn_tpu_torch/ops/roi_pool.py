"""RoIPool (max-pool RoI pooling), for parity with the JAX package.

Port of ``stereo_rcnn_tpu.ops.roi_pool`` (a copy of its semantics in plain
torch; it has no kernel there either).  The stereo pipeline never uses
RoIPool; RoIAlign is the production pooling.  Each bin is the max over an
S x S grid of nearest-cell taps of one feature map.
"""

from __future__ import annotations

import torch


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
             spatial_scale: float, samples_per_bin: int = 4) -> torch.Tensor:
    """Max-pool RoI pooling on one feature map.

    Args:
      feat: [H, W, C].
      rois: [R, 4] xyxy in image coordinates.
      output_size: P: output [R, P, P, C].
      samples_per_bin: S: each bin takes the max over an S x S grid of
        nearest-cell taps (S >= the bin's size in cells gives the exact
        max-pool).
    """
    h, w = feat.shape[:2]
    p, s = output_size, samples_per_bin
    scaled = rois.float() * spatial_scale
    x1, y1 = scaled[:, 0], scaled[:, 1]
    roi_w = torch.clamp(scaled[:, 2] - x1, min=1.0)
    roi_h = torch.clamp(scaled[:, 3] - y1, min=1.0)

    grid = (torch.arange(p * s, dtype=torch.float32, device=feat.device)
            + 0.5) / s
    ys = y1[:, None] + grid * (roi_h / p)[:, None]          # [R, PS]
    xs = x1[:, None] + grid * (roi_w / p)[:, None]
    # jnp.round rounds half to even, as torch.round does.
    yi = torch.clamp(torch.round(ys - 0.5), 0, h - 1).long()
    xi = torch.clamp(torch.round(xs - 0.5), 0, w - 1).long()

    taps = feat[yi[:, :, None], xi[:, None, :]]             # [R, PS, PS, C]
    r, c = rois.shape[0], feat.shape[-1]
    taps = taps.reshape(r, p, s, p, s, c)
    return taps.amax(dim=(2, 4))
