"""FPN level routing for RoIAlign (port of ``stereo_rcnn_tpu.ops.roi_align``).

Only the level assignment is ported; the JAX package's XLA atlas RoIAlign
(``multilevel_roi_align``) is not on the port's path yet (see ROADMAP.md).
"""

from __future__ import annotations

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
