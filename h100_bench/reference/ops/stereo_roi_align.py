"""The fused stereo RoIAlign of the measured program, as plain PyTorch in
float32: a frozen copy of the program's plain version with the exact
("f32") sampling weights, whatever ``rcnn.roi_align_hat`` the program
runs.  Per image and roi one packed block of ``294 x C`` rows: 196 left
14x14 samples (keypoint branch), the left 7x7 pool (their 2x2 means), the
right 7x7 pool at sampling ratio 2.  Samples are clamped to a per-level
window.  The gradient is autograd's, through the gathers.
"""

from __future__ import annotations

from typing import Sequence

import torch

from h100_bench.reference.ops.roi_align import fpn_level_assignment

# Per-level sampling windows of the TPU kernel (roi_align_pallas.py
# _STEREO_WIN), clamped to each level; samples are clamped to the window.
STEREO_WIN = ((48, 64), (48, 64), (24, 64), (12, 40))
PK = 14                     # kpt samples per axis
P = 7                       # pooled bins per axis
ROWS = PK * PK + 2 * P * P  # 294

_TABLES: dict = {}


def device_table(rows, device) -> torch.Tensor:
    """The float32 table ``rows`` on ``device``, made once per content and
    device: a host-to-device copy of a Python list waits for the stream, so
    the wrappers look their small per-level tables up here instead."""
    key = (tuple(tuple(float(v) for v in row) for row in rows), str(device))
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(rows, dtype=torch.float32,
                                            device=device)
    return table


def window_shapes(level_shapes, windows=STEREO_WIN):
    """Each level's sampling window of ``windows`` clamped to the level."""
    return [(min(h, bh), min(w, bw))
            for (h, w), (bh, bw) in zip(level_shapes, windows)]


def roi_window_meta(level_shapes, rois: torch.Tensor,
                    strides: Sequence[int], ps: int = PK,
                    windows=STEREO_WIN):
    """meta int32 ``[..., 4]`` (level, y0, x0, valid) and geom float32
    ``[..., 4]`` (y1, x1, bin_h, bin_w) in window coordinates, for ``ps``
    bins per axis and the per-level ``windows``; window origins are
    8-aligned on the W axis as in the TPU kernel."""
    levels = fpn_level_assignment(rois, len(level_shapes))
    table = device_table(
        [[1.0 / s, h, w, wh, ww] for s, (h, w), (wh, ww)
         in zip(strides, level_shapes, window_shapes(level_shapes, windows))],
        rois.device)[levels]
    lvl_scale, lvl_h, lvl_w, win_h, win_w = table.unbind(-1)
    scaled = rois * lvl_scale[..., None]
    x1, y1 = scaled[..., 0], scaled[..., 1]
    roi_w = torch.clamp(scaled[..., 2] - x1, min=1.0)
    roi_h = torch.clamp(scaled[..., 3] - y1, min=1.0)
    zero = torch.zeros_like(lvl_h)
    y0 = torch.clamp(torch.floor(y1 + roi_h / 2 - win_h / 2), zero,
                     torch.clamp(lvl_h - win_h, min=0.0)).int()
    x0 = torch.clamp(torch.floor(x1 + roi_w / 2 - win_w / 2), zero,
                     torch.clamp(lvl_w - win_w, min=0.0)).int()
    x0 = (x0 // 8) * 8
    # Validity from the raw rois: zero-area padded rois give zero output.
    valid = (rois[..., 2] > rois[..., 0]) & (rois[..., 3] > rois[..., 1])
    meta = torch.stack([levels.int(), y0, x0, valid.int()], dim=-1)
    geom = torch.stack([y1 - y0.float(), x1 - x0.float(),
                        roi_h / ps, roi_w / ps], dim=-1)
    return meta.contiguous(), geom.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------

def _fused_multiply_add(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add
    gives it (the float32 product is exact in float64).  Every sample
    position is computed so, as XLA computes the JAX kernels' positions on
    the CPU and as the CUDA kernels do (``__fmaf_rn``)."""
    return (a.double() * b.double() + c.double()).float()


def _axis_taps(start, step, origin, bound, grid):
    """Bilinear taps of the positions ``start + grid * step`` clamped to
    ``[0, bound]`` (``[..., 1]`` operands, ``grid`` ``[n]``): the cells
    ``lo = floor(p)`` and ``hi = min(lo + 1, bound)``, each offset by
    ``origin``, and the fraction ``p - lo`` (weights 1 - f on lo, f on hi)."""
    pos = torch.minimum(torch.clamp(_fused_multiply_add(grid, step, start),
                                    min=0.0), bound)
    lo = torch.floor(pos)
    return lo + origin, torch.minimum(lo + 1.0, bound) + origin, pos - lo


def _taps(meta, geom, win, n: int, s: int = 1):
    """Taps of a side's n x n sample grid at ``(k + 0.5) / s`` bins, each
    ``[B, R, n]``: absolute level rows ``y_lo``/``y_hi`` and columns
    ``x_lo``/``x_hi`` and the fractions ``fy``/``fx``; samples are clamped
    to the window."""
    dev = meta.device
    win_hw = device_table(win, dev)[meta[..., 0].long()]
    grid = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / s
    y_lo, y_hi, fy = _axis_taps(geom[..., 0:1], geom[..., 2:3],
                               meta[..., 1:2].float(), win_hw[..., 0:1] - 1.0,
                               grid)
    x_lo, x_hi, fx = _axis_taps(geom[..., 1:2], geom[..., 3:4],
                               meta[..., 2:3].float(), win_hw[..., 1:2] - 1.0,
                               grid)
    return y_lo, y_hi, x_lo, x_hi, fy, fx


def _atlas_index(level_shapes, meta):
    """``index(rows, cols) -> [B, R, n, m]`` row indices into the levels of
    all images concatenated (``[B * sum(H_l * W_l), C]``)."""
    b = meta.shape[0]
    dev = meta.device
    level = meta[..., 0].long()
    sizes = [h * w for h, w in level_shapes]
    total = sum(sizes)
    offsets = (torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                            device=dev)[level] +
               torch.arange(b, device=dev)[:, None] * total)[..., None, None]
    lvl_w = torch.tensor([w for _, w in level_shapes],
                         device=dev)[level][..., None, None]

    def index(rows, cols):
        return (offsets + rows.long()[..., :, None] * lvl_w +
                cols.long()[..., None, :])
    return index


def _flat_levels(feats):
    b, c = feats[0].shape[0], feats[0].shape[-1]
    return torch.cat([f.reshape(b, -1, c) for f in feats],
                     dim=1).reshape(-1, c)


def _bilinear(tap, y_lo, y_hi, x_lo, x_hi, fy, fx) -> torch.Tensor:
    """``[B, R, n, n, C]`` float32 samples from four gathered taps
    (``tap(rows, cols)``), weighted y first, then x."""
    wyl, wyh = (1.0 - fy)[..., :, None, None], fy[..., :, None, None]
    wxl, wxh = (1.0 - fx)[..., None, :, None], fx[..., None, :, None]
    t0 = wyl * tap(y_lo, x_lo) + wyh * tap(y_hi, x_lo)
    t1 = wyl * tap(y_lo, x_hi) + wyh * tap(y_hi, x_hi)
    return wxl * t0 + wxh * t1


def sample_side(feats, meta, geom, win, n: int, s: int = 1) -> torch.Tensor:
    """[B, R, n, n, C] float32 bilinear samples of one side."""
    index = _atlas_index([(f.shape[1], f.shape[2]) for f in feats], meta)
    atlas = _flat_levels(feats)
    return _bilinear(lambda rows, cols: atlas[index(rows, cols)].float(),
                    *_taps(meta, geom, win, n, s))


def stereo_roi_align_packed(feats_l, feats_r, rois_l, rois_r, strides,
                            hat: str = "f32") -> torch.Tensor:
    """``[B, R, 294, C]`` float32 (``hat`` is ignored: the reference
    samples with exact weights)."""
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
    win = window_shapes(level_shapes)
    b, r = rois_l.shape[:2]
    c = feats_l[0].shape[-1]
    meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
    meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
    zero = torch.zeros((), dtype=torch.float32, device=rois_l.device)
    ok_l = meta_l[..., 3:4, None] > 0
    ok_r = meta_r[..., 3:4, None] > 0
    left = sample_side(feats_l, meta_l, geom_l, win, PK)
    right = sample_side(feats_r, meta_r, geom_r, win, PK)
    pool_r = right.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    pool_l = left.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    return torch.cat([
        torch.where(ok_l, left.reshape(b, r, PK * PK, c), zero),
        torch.where(ok_l, pool_l.reshape(b, r, P * P, c), zero),
        torch.where(ok_r, pool_r.reshape(b, r, P * P, c), zero)], dim=2)
