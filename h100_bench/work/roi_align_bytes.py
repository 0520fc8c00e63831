"""Bytes the fused stereo RoIAlign must move, from its shapes: each input
read once and each output written once (the bound of a kernel that
streams; what a kernel reads again is not counted).

K1, the forward: the packed ``[B, R, 294, C]`` float32 block out and the
rois in, and, with ``levels``, both sides' levels P2..P5 in whole
(``feature_bytes`` per element).  The kernel reads only the windows its
rois sample, a part of each level that depends on where the rois lie:
the levels whole are the bound of rois spread over the image (the
kernel-alone timing's), and the pipeline's proposals, which cluster,
read less (K1 ran at 107 % of that bound in the pipeline); the bound of
the pipeline's K1 counts the output and the rois alone.  K2, the
backward: the packed cotangent rows that valid rois need (left 196 +
49, right 49) in; both sides' float32 level gradients out (every cell
is written).
"""

from __future__ import annotations

from typing import Sequence, Tuple

PK, P = 14, 7
ROWS = PK * PK + 2 * P * P          # 294
LEVEL_STRIDES = (4, 8, 16, 32)      # P2..P5


def level_cells(image_hw: Tuple[int, int],
                strides: Sequence[int] = LEVEL_STRIDES) -> int:
    h, w = image_hw
    return sum(-(-h // s) * -(-w // s) for s in strides)


def k1_bytes(batch: int, rois: int, channels: int,
             image_hw: Tuple[int, int], feature_bytes: int = 2,
             levels: bool = True) -> int:
    read = (2 * batch * level_cells(image_hw) * channels * feature_bytes
            if levels else 0)
    roi_in = 2 * batch * rois * 4 * 4
    out = batch * rois * ROWS * channels * 4
    return read + roi_in + out


def k2_bytes(batch: int, rois: int, channels: int,
             image_hw: Tuple[int, int], valid_left: int | None = None,
             valid_right: int | None = None) -> int:
    n_l = batch * rois if valid_left is None else valid_left
    n_r = batch * rois if valid_right is None else valid_right
    cotangent = (n_l * (PK * PK + P * P) + n_r * P * P) * channels * 4
    grads = 2 * batch * level_cells(image_hw) * channels * 4
    return cotangent + grads
