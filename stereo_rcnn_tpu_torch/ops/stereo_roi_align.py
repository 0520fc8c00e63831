"""Fused stereo RoIAlign, its gradient and its atlas variant: the CUDA
kernels ``csrc/stereo_roi_align.cu`` (K1, forward),
``csrc/stereo_roi_align_bwd.cu`` (K2, backward) and
``csrc/stereo_roi_align_atlas.cu`` (K4), and their plain PyTorch versions.

K1 and K2 port ``stereo_rcnn_tpu.ops.roi_align_pallas.
stereo_roi_align_batched_packed`` and its custom VJP.  Per image and roi
the forward returns one packed block of ``294 x C`` float32 rows: 196 left
14x14 samples (keypoint branch), the left 7x7 pool (their 2x2 means), the
right 7x7 pool at sampling ratio 2.  ``hat`` selects the sampling weights
(``rcnn.roi_align_hat``): ``"f32"`` exact, or the single combined kron
weight per (sample, window cell) rounded to bf16 (``"kron_bf16"``) or
split into bf16 hi + lo (``"kron_hilo"``).  The kernel-level entry
(:class:`StereoRoIAlignKernel` and the plain version) also takes the
two-matmul modes ``"bf16"`` and ``"hilo"`` of :data:`TOOL_HAT_MODES`,
which the JAX package reaches only through ``stereo_roi_align_pallas``;
the public entry refuses them, as JAX's ``_HAT_MODES`` does.  Levels
P2..P5 are NHWC ``[B, H_l, W_l, C]``; rois are ``[B, R, 4]`` xyxy float32
in image coordinates.  The backward, whatever the hat, is the exact f32
transpose (as in the JAX package): it scatters a packed cotangent back
through the f32 bilinear taps into float32 per-level gradients, cast to
the features' dtype; the rois get no gradient.  K2 sums each gradient
cell in one fixed order (no atomics), so two launches give the same bits.
The forward is the registered op ``stereo_rcnn_tpu_torch::
stereo_roi_align_fwd`` (:func:`stereo_roi_align_fwd`), so that
``torch.export`` keeps it as one graph node; the op dispatches by device.

K4 ports ``stereo_roi_align_pallas_atlas``: K1's f32 sampling over a
row-packed level atlas (:func:`pack_atlas`, :func:`atlas_meta`), returning
``(out7l, out7r, out14l)``; it has no gradient.

:func:`roi_window_meta` computes the level, window and sample geometry on
the tensors' device; the kernels and the plain versions all read it, so
they never disagree on a level or window.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from stereo_rcnn_tpu_torch.ops.cuda_build import (CudaKernel, check_levels,
                                                  on_device)
from stereo_rcnn_tpu_torch.ops.roi_align import fpn_level_assignment

# Per-level sampling windows of the TPU kernel (roi_align_pallas.py
# _STEREO_WIN), clamped to each level; samples are clamped to the window.
STEREO_WIN = ((48, 64), (48, 64), (24, 64), (12, 40))
PK = 14                     # kpt samples per axis
P = 7                       # pooled bins per axis
ROWS = PK * PK + 2 * P * P  # 294
# Sampling-weight modes of the public entry (roi_align_pallas.py
# _HAT_MODES, rcnn.roi_align_hat) and the kernel's code for each.
HAT_MODES = {"f32": 0, "kron_bf16": 1, "kron_hilo": 2}
# The modes the kernel-level entry also takes: _sample_grid's two-matmul
# branch with hat_dtype=jnp.bfloat16 ("bf16") and "hilo", which the JAX
# package reaches only through stereo_roi_align_pallas (its
# tools/bench_roialign.py), never through _HAT_MODES.
TOOL_HAT_MODES = {**HAT_MODES, "bf16": 3, "hilo": 4}
ATLAS_WIN = (48, 64)        # K4's window; its atlas adds ATLAS_WIN[0] rows

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


def _kron_side(feats, meta, geom, win, n: int, avg: int, hat: str,
               chunk: int = 64) -> torch.Tensor:
    """``[B, R, n * n, C]`` float32: ``_sample_grid``'s kron branch taken
    literally.  Per roi, the dense weight matrix ``[n * n, wh * ww]`` over
    the largest window, ``W = (sum_a hat_y,a) * (sum_a hat_x,a) / avg^2``
    with ``hat(cell) = max(0, 1 - |cell - p|)`` and ``p`` at
    ``y1 + (i * avg + a + 0.5) * bin`` clamped to the level's window;
    rounded to bf16 (``kron_bf16``) or split into bf16 hi + lo
    (``kron_hilo``), and contracted in float32 with the window, whose
    cells beyond the level's window are zero.  ``chunk`` rois at a time.
    Positions are rounded once (:func:`_fused_multiply_add`): one an ulp
    apart can flip a weight's bf16 rounding."""
    b, r = meta.shape[:2]
    c = feats[0].shape[-1]
    wy, wx, window = _hat_rows(feats, meta, geom, win, n, avg)
    wh, ww = wy.shape[-1], wx.shape[-1]
    wy = wy.reshape(b * r, n, 1, wh, 1)
    wx = wx.reshape(b * r, 1, n, 1, ww)
    out = []
    for i in range(0, b * r, chunk):
        sl = slice(i, i + chunk)
        # The hats are sums over the avg samples here: scale once.
        wgt = (wy[sl] * wx[sl] * (1.0 / (avg * avg))).reshape(-1, n * n,
                                                              wh * ww)
        hi, lo = _hi_lo(wgt)
        win_c = window(sl).reshape(-1, wh * ww, c)
        res = torch.bmm(hi, win_c)
        if hat == "kron_hilo":
            res = res + torch.bmm(lo, win_c)
        out.append(res)
    return torch.cat(out).reshape(b, r, n * n, c)


def _hi_lo(w):
    """``w`` rounded to bf16 (hi) and its remainder rounded to bf16 (lo),
    both as float32: ``roi_align_pallas.py::_hi_lo``."""
    hi = w.to(torch.bfloat16).float()
    return hi, (w - hi).to(torch.bfloat16).float()


def _hat_rows(feats, meta, geom, win, n: int, avg: int):
    """The hat rows of a side's samples over the largest window and a
    gather of its windows: ``wy [B, R, n, wh]``, ``wx [B, R, n, ww]``, each
    the SUM over a bin's ``avg`` samples of ``max(0, 1 - |cell - p|)``, ``p``
    at ``y1 + (i * avg + a + 0.5) * bin`` (rounded once) clamped to the
    level's window; and ``window(rows)``, the float32 windows ``[k, wh,
    ww, C]`` of the rois ``rows`` (a slice of the ``B * R`` rois), zero
    beyond the level's window.  Cells beyond it get zero hats anyway."""
    b, r = meta.shape[:2]
    c = feats[0].shape[-1]
    dev = meta.device
    f32 = torch.float32
    wh, ww = max(h for h, _ in win), max(w for _, w in win)
    win_hw = device_table(win, dev)[meta[..., 0].long()]
    win_h, win_w = win_hw[..., 0:1], win_hw[..., 1:2]            # [B, R, 1]
    cell_h = torch.arange(wh, dtype=f32, device=dev)
    cell_w = torch.arange(ww, dtype=f32, device=dev)
    rows = torch.minimum(cell_h, win_h - 1.0) + meta[..., 1:2].float()
    cols = torch.minimum(cell_w, win_w - 1.0) + meta[..., 2:3].float()
    index = _atlas_index([(f.shape[1], f.shape[2]) for f in feats],
                         meta)(rows, cols).reshape(b * r, wh * ww)
    inside = ((cell_h < win_h)[..., :, None] &
              (cell_w < win_w)[..., None, :]).reshape(b * r, wh * ww, 1)
    atlas = _flat_levels(feats)

    idx = torch.arange(n, dtype=f32, device=dev)
    wy = wx = 0.0
    for a in range(avg):
        k = idx * avg + a + 0.5
        ys = torch.minimum(torch.clamp(
            _fused_multiply_add(k, geom[..., 2:3], geom[..., 0:1]),
            min=0.0), win_h - 1.0)                     # [B, R, n]
        xs = torch.minimum(torch.clamp(
            _fused_multiply_add(k, geom[..., 3:4], geom[..., 1:2]),
            min=0.0), win_w - 1.0)
        wy = wy + torch.clamp(1.0 - torch.abs(cell_h - ys[..., None]),
                              min=0.0)                 # [B, R, n, wh]
        wx = wx + torch.clamp(1.0 - torch.abs(cell_w - xs[..., None]),
                              min=0.0)                 # [B, R, n, ww]

    def window(sl):
        return torch.where(inside[sl], atlas[index[sl]].float(),
                           torch.zeros((), dtype=f32, device=dev)
                           ).reshape(-1, wh, ww, c)
    return wy, wx, window


def _two_matmul_side(feats, meta, geom, win, n: int, avg: int, hat: str,
                     chunk: int = 64) -> torch.Tensor:
    """``[B, R, n, n, C]`` float32: ``_sample_grid``'s two-matmul branch
    taken literally (``roi_align_pallas.py:311-356``), ``"bf16"`` for
    ``hat_dtype=jnp.bfloat16`` and ``"hilo"``.  Per roi the hat rows ``wy
    [n, wh]`` and ``wx [n, ww]`` of :func:`_hat_rows`, each the MEAN over a
    bin's ``avg`` samples (summed, then halved); the window contracted with
    ``wy`` over its rows, then with ``wx`` over its columns, in float32.
    ``bf16``: ``wy``, the intermediate and ``wx`` rounded to bf16.
    ``hilo``: ``wy`` split into bf16 hi + lo (two y-passes, summed), the
    intermediate and ``wx`` split too, and the three products hi x hi,
    hi x lo, lo x hi summed in that order (lo x lo dropped)."""
    b, r = meta.shape[:2]
    c = feats[0].shape[-1]
    wy, wx, window = _hat_rows(feats, meta, geom, win, n, avg)
    if avg > 1:
        wy = wy * (1.0 / avg)       # exact: the mean of jnp.mean
        wx = wx * (1.0 / avg)
    wh, ww = wy.shape[-1], wx.shape[-1]
    wy = wy.reshape(b * r, n, wh)
    wx = wx.reshape(b * r, 1, n, ww)
    out = []
    for i in range(0, b * r, chunk):
        sl = slice(i, i + chunk)
        wy_hi, wy_lo = _hi_lo(wy[sl])
        wx_hi, wx_lo = _hi_lo(wx[sl])
        win_c = window(sl).reshape(-1, wh, ww * c)
        if hat == "bf16":
            tmp = torch.bmm(wy_hi, win_c).reshape(-1, n, ww, c)
            res = torch.matmul(wx_hi, _hi_lo(tmp)[0])
        else:
            tmp = (torch.bmm(wy_hi, win_c) +
                   torch.bmm(wy_lo, win_c)).reshape(-1, n, ww, c)
            t_hi, t_lo = _hi_lo(tmp)
            res = (torch.matmul(wx_hi, t_hi) + torch.matmul(wx_hi, t_lo) +
                   torch.matmul(wx_lo, t_hi))
        out.append(res)                # [k, n(y), n(x), C]: y-major
    return torch.cat(out).reshape(b, r, n, n, c)


def stereo_roi_align_packed_ref(feats_l, feats_r, rois_l, rois_r, strides,
                                hat: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of K1: ``[B, R, 294, C]`` float32; ``hat`` is
    one of :data:`TOOL_HAT_MODES` (others raise ``KeyError``)."""
    if hat not in TOOL_HAT_MODES:
        raise KeyError(hat)
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
    win = window_shapes(level_shapes)
    b, r = rois_l.shape[:2]
    c = feats_l[0].shape[-1]
    meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
    meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
    zero = torch.zeros((), dtype=torch.float32, device=rois_l.device)
    ok_l = meta_l[..., 3:4, None] > 0
    ok_r = meta_r[..., 3:4, None] > 0
    if hat == "f32":
        left = sample_side(feats_l, meta_l, geom_l, win, PK)
        right = sample_side(feats_r, meta_r, geom_r, win, PK)
        pool_r = right.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    elif hat in ("bf16", "hilo"):
        # As the TPU kernel calls _sample_grid: the left side at ps=14, the
        # right side's pool at ps=7 with avg=2.
        left = _two_matmul_side(feats_l, meta_l, geom_l, win, PK, 1, hat)
        pool_r = _two_matmul_side(feats_r, meta_r, geom_r, win, P, 2, hat)
    else:
        # The right side folds its 2x2 bin mean into the weights (avg 2).
        left = _kron_side(feats_l, meta_l, geom_l, win, PK, 1, hat)
        pool_r = _kron_side(feats_r, meta_r, geom_r, win, P, 2, hat)
    pool_l = left.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    return torch.cat([
        torch.where(ok_l, left.reshape(b, r, PK * PK, c), zero),
        torch.where(ok_l, pool_l.reshape(b, r, P * P, c), zero),
        torch.where(ok_r, pool_r.reshape(b, r, P * P, c), zero)], dim=2)


def _tap_contributions(g_samples, meta, geom, win, level_shapes, n: int):
    """Transpose of :func:`sample_side` as scatter operands: for each of
    the four taps, (rows [M] of the all-images atlas, weighted cotangent
    [M, C]) for the [B, R, n, n, C] sample cotangent ``g_samples``."""
    c = g_samples.shape[-1]
    y_lo, y_hi, x_lo, x_hi, fy, fx = _taps(meta, geom, win, n)
    index = _atlas_index(level_shapes, meta)
    out = []
    for rows, wy in ((y_lo, 1.0 - fy), (y_hi, fy)):
        for cols, wx in ((x_lo, 1.0 - fx), (x_hi, fx)):
            w = wy[..., :, None] * wx[..., None, :]             # [B, R, n, n]
            out.append((index(rows, cols).reshape(-1),
                        (w[..., None] * g_samples).reshape(-1, c)))
    return out


def packed_bwd_contributions(g_packed, rois_l, rois_r, level_shapes,
                             strides):
    """The backward as scatter operands, ``[left, right]``, each the four
    taps' (atlas rows, weighted cotangent) of :func:`_tap_contributions`.
    The left sample cotangent is ``d14 + up2(d7l) / 4``, the right
    ``up2(d7r) / 4``, each zero where the roi is not valid."""
    b, r, _, c = g_packed.shape
    win = window_shapes(level_shapes)
    meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
    meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
    kk, pp = PK * PK, P * P
    g = g_packed.float()

    def up(d):                      # [B, R, P, P, C] -> [B, R, PK, PK, C]
        return (d.reshape(b, r, P, P, c).repeat_interleave(2, dim=2)
                .repeat_interleave(2, dim=3) * 0.25)

    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    g_left = torch.where(meta_l[..., 3, None, None, None] > 0,
                         g[:, :, :kk].reshape(b, r, PK, PK, c) +
                         up(g[:, :, kk:kk + pp]), zero)
    g_right = torch.where(meta_r[..., 3, None, None, None] > 0,
                          up(g[:, :, kk + pp:]), zero)
    return [_tap_contributions(g_left, meta_l, geom_l, win, level_shapes, PK),
            _tap_contributions(g_right, meta_r, geom_r, win, level_shapes,
                               PK)]


def stereo_roi_align_packed_bwd_ref(g_packed, rois_l, rois_r, level_shapes,
                                    strides):
    """Plain PyTorch version of the backward kernel: the packed cotangent
    ``[B, R, 294, C]`` float32 -> ``(d_feats_l, d_feats_r)``, lists of
    float32 ``[B, H_l, W_l, C]``.  An explicit transpose, as the TPU
    kernel's: the left sample cotangent is ``d14 + up2(d7l) / 4``, the
    right ``up2(d7r) / 4``, each zero where the roi is not valid,
    ``index_add_``-ed through the forward's four taps of every sample."""
    b, c = g_packed.shape[0], g_packed.shape[-1]
    sizes = [h * w for h, w in level_shapes]
    grads = []
    for side in packed_bwd_contributions(g_packed, rois_l, rois_r,
                                         level_shapes, strides):
        acc = torch.zeros((b * sum(sizes), c), dtype=torch.float32,
                          device=g_packed.device)
        for index, values in side:
            acc.index_add_(0, index, values)
        per_image = acc.reshape(b, sum(sizes), c).split(sizes, dim=1)
        grads.append([x.reshape(b, h, w, c)
                      for x, (h, w) in zip(per_image, level_shapes)])
    return grads[0], grads[1]


def pack_atlas(feats):
    """Row-concatenate the levels ``[B, H_l, W_l, C]`` of one side, widths
    zero-padded to the widest level, plus ``ATLAS_WIN[0]`` zero rows (the
    TPU kernel's window runway): ``(atlas [B, sum H_l + 48, W_max, C],
    row offset of each level)``."""
    wmax = max(f.shape[2] for f in feats)
    b, c = feats[0].shape[0], feats[0].shape[-1]
    rows = [F.pad(f, (0, 0, 0, wmax - f.shape[2])) for f in feats]
    rows.append(feats[0].new_zeros((b, ATLAS_WIN[0], wmax, c)))
    offsets = [sum(f.shape[1] for f in feats[:i]) for i in range(len(feats))]
    return torch.cat(rows, dim=1), offsets


def atlas_meta(level_shapes, rois: torch.Tensor, strides: Sequence[int]):
    """K4's metadata: meta int32 ``[..., 4]`` (atlas y0, x0, valid, 0) and
    geom float32 ``[..., 6]`` (y1, x1, bin_h, bin_w, clamp_y, clamp_x): the
    window of :func:`roi_window_meta` moved to the level's atlas rows, and
    as clamp bounds the last row and column of the level's window."""
    meta, geom = roi_window_meta(level_shapes, rois, strides)
    offsets = [sum(h for h, _ in level_shapes[:i])
               for i in range(len(level_shapes))]
    table = device_table(
        [[off, wh - 1, ww - 1] for off, (wh, ww)
         in zip(offsets, window_shapes(level_shapes))],
        rois.device)[meta[..., 0].long()]
    meta_a = torch.stack([meta[..., 1] + table[..., 0].int(), meta[..., 2],
                          meta[..., 3], torch.zeros_like(meta[..., 3])],
                         dim=-1)
    return meta_a.contiguous(), torch.cat([geom, table[..., 1:]],
                                          dim=-1).contiguous()


def _atlas_taps(meta, geom, n: int):
    grid = torch.arange(n, dtype=torch.float32, device=meta.device) + 0.5
    y_lo, y_hi, fy = _axis_taps(geom[..., 0:1], geom[..., 2:3],
                               meta[..., 0:1].float(), geom[..., 4:5], grid)
    x_lo, x_hi, fx = _axis_taps(geom[..., 1:2], geom[..., 3:4],
                               meta[..., 1:2].float(), geom[..., 5:6], grid)
    return y_lo, y_hi, x_lo, x_hi, fy, fx


def stereo_roi_align_atlas_ref(feats_l, feats_r, rois_l, rois_r, strides):
    """Plain PyTorch version of K4: ``(out7l [B, R, 7, 7, C], out7r,
    out14l [B, R, 14, 14, C])`` float32, sampled from the packed atlases
    with the per-roi clamp bounds."""
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
    b, r = rois_l.shape[:2]
    outs = []
    for feats, rois in ((feats_l, rois_l), (feats_r, rois_r)):
        atlas, _ = pack_atlas(list(feats))
        ah, aw, c = atlas.shape[1:]
        flat = atlas.reshape(-1, c)
        meta, geom = atlas_meta(level_shapes, rois, strides)
        base = (torch.arange(b, device=rois.device) * (ah * aw))[
            :, None, None, None]

        def tap(rows, cols):
            idx = base + rows.long()[..., :, None] * aw + \
                cols.long()[..., None, :]
            return flat[idx].float()
        samples = _bilinear(tap, *_atlas_taps(meta, geom, PK))
        samples = torch.where(meta[..., 2, None, None, None] > 0, samples,
                              torch.zeros((), device=samples.device))
        outs.append(samples)
    left, right = outs
    c = left.shape[-1]
    pool = [x.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5)) for x in outs]
    return pool[0], pool[1], left


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------

def _check_rois(rois_l, rois_r, b, r):
    for rois in (rois_l, rois_r):
        if rois.shape != (b, r, 4) or rois.dtype != torch.float32:
            raise ValueError("rois must be float32 [B, R, 4], got "
                             f"{rois.dtype} {tuple(rois.shape)}")
        if rois.device != rois_l.device:
            raise ValueError("left and right rois must share a device")


def _check_pyramids(feats_l, feats_r, rois_l, rois_r):
    """``(dtype, B, R, C)`` of two 4-level pyramids the kernels take."""
    if len(feats_l) != 4 or len(feats_r) != 4:
        raise ValueError("the kernel takes exactly 4 levels (P2..P5) per "
                         "side")
    b, r = rois_l.shape[:2]
    dtype, c = check_levels(feats_l, rois_l.device, b)
    if (check_levels(feats_r, rois_l.device, b) != (dtype, c) or
            any(f_l.shape != f_r.shape for f_l, f_r in zip(feats_l, feats_r))):
        raise ValueError("left and right pyramids differ in shape or dtype")
    _check_rois(rois_l, rois_r, b, r)
    return dtype, b, r, c


_P = ctypes.c_void_p
_I = ctypes.c_int


class StereoRoIAlignKernel(CudaKernel):
    """K1: ``stereo_roi_align_fwd`` (the forward), in every mode of
    :data:`TOOL_HAT_MODES` (the kernel-level entry, as the JAX package's
    ``stereo_roi_align_pallas``); ``launches_by_hat`` counts the launches of
    each mode."""

    source = "stereo_roi_align.cu"
    symbol = "stereo_roi_align_fwd"
    argtypes = [_P] * 9 + [_I] * 5 + [_P]

    def __init__(self):
        super().__init__()
        self.reset_counts()

    def reset_counts(self) -> None:
        super().reset_counts()
        self.launches_by_hat = dict.fromkeys(TOOL_HAT_MODES, 0)

    def __call__(self, feats_l, feats_r, rois_l, rois_r, strides,
                 hat: str = "f32") -> torch.Tensor:
        mode = TOOL_HAT_MODES[hat]  # KeyError for an unknown mode
        fn = self.load()
        feats_l, feats_r = list(feats_l), list(feats_r)
        dtype, b, r, c = _check_pyramids(feats_l, feats_r, rois_l, rois_r)
        dev = rois_l.device
        level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
        # Both sides in one pass: half the small launches of the metadata.
        meta, geom = roi_window_meta(level_shapes,
                                     torch.stack([rois_l, rois_r]), strides)
        out = torch.empty((b, r, ROWS, c), dtype=torch.float32, device=dev)
        ptrs = ctypes.c_void_p * 4
        ints = ctypes.c_int * 8
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ptrs(*[f.data_ptr() for f in feats_l]),
                     ptrs(*[f.data_ptr() for f in feats_r]),
                     ints(*[v for hw in level_shapes for v in hw]),
                     ints(*[v for hw in window_shapes(level_shapes)
                            for v in hw]),
                     meta[0].data_ptr(), geom[0].data_ptr(),
                     meta[1].data_ptr(), geom[1].data_ptr(), out.data_ptr(),
                     b, r, c, int(dtype == torch.bfloat16), mode, stream)
        self._launched(err)
        self.launches_by_hat[hat] += 1
        return out


class StereoRoIAlignBwdKernel(CudaKernel):
    """K2: ``stereo_roi_align_bwd`` (the backward)."""

    source = "stereo_roi_align_bwd.cu"
    symbol = "stereo_roi_align_bwd"
    argtypes = [_P] * 9 + [_I] * 3 + [_P]

    def __call__(self, g_packed, rois_l, rois_r, level_shapes, strides):
        """float32 ``(d_feats_l, d_feats_r)`` lists of ``[B, H_l, W_l, C]``
        for the packed cotangent ``g_packed`` [B, R, 294, C] float32, any C
        (8-channel lanes where C % 4 == 0, 2-channel lanes for any other
        even C, else 1-channel lanes).  The kernel writes every gradient
        cell once, so they are allocated uninitialised."""
        fn = self.load()
        level_shapes = [tuple(hw) for hw in level_shapes]
        if len(level_shapes) != 4:
            raise ValueError("the kernel takes exactly 4 levels (P2..P5)")
        dev = g_packed.device
        b, r = rois_l.shape[:2]
        c = g_packed.shape[-1]
        if (g_packed.dtype != torch.float32 or
                g_packed.shape != (b, r, ROWS, c) or
                not g_packed.is_contiguous()):
            raise ValueError(f"cotangent must be contiguous float32 "
                             f"[{b}, {r}, {ROWS}, C], got {g_packed.dtype} "
                             f"{tuple(g_packed.shape)}")
        _check_rois(rois_l, rois_r, b, r)
        if rois_l.device != dev:
            raise ValueError("rois and cotangent must share a device")
        if g_packed.data_ptr() % 16:
            g_packed = g_packed.clone()    # the kernel's 16-byte loads
        meta, geom = roi_window_meta(level_shapes,
                                     torch.stack([rois_l, rois_r]), strides)
        d_l = [torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
               for h, w in level_shapes]
        d_r = [torch.empty_like(d) for d in d_l]
        ptrs = ctypes.c_void_p * 4
        ints = ctypes.c_int * 8
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ptrs(*[d.data_ptr() for d in d_l]),
                     ptrs(*[d.data_ptr() for d in d_r]),
                     ints(*[v for hw in level_shapes for v in hw]),
                     ints(*[v for hw in window_shapes(level_shapes)
                            for v in hw]),
                     meta[0].data_ptr(), geom[0].data_ptr(),
                     meta[1].data_ptr(), geom[1].data_ptr(),
                     g_packed.data_ptr(), b, r, c, stream)
        self._launched(err)
        return d_l, d_r


class StereoRoIAlignAtlasKernel(CudaKernel):
    """K4: ``stereo_roi_align_atlas_fwd`` over packed atlases."""

    source = "stereo_roi_align_atlas.cu"
    symbol = "stereo_roi_align_atlas_fwd"
    argtypes = [_P] * 9 + [_I] * 6 + [_P]

    def __call__(self, atlas_l, atlas_r, level_shapes, rois_l, rois_r,
                 strides):
        """``(out7l, out7r, out14l)`` float32 for the atlases of
        :func:`pack_atlas` (``[B, sum H_l + 48, W_max, C]`` per side) of
        levels shaped ``level_shapes``."""
        fn = self.load()
        dev = rois_l.device
        b, r = rois_l.shape[:2]
        dtype = atlas_l.dtype
        if dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"atlases must be bfloat16 or float32, got "
                            f"{dtype}")
        ah, aw, c = atlas_l.shape[1:]
        if (atlas_l.shape != atlas_r.shape or atlas_r.dtype != dtype or
                atlas_l.shape[0] != b or
                ah != sum(h for h, _ in level_shapes) + ATLAS_WIN[0] or
                aw != max(w for _, w in level_shapes)):
            raise ValueError(f"atlases {tuple(atlas_l.shape)}, "
                             f"{tuple(atlas_r.shape)} do not pack levels "
                             f"{level_shapes} of {b} images")
        for a in (atlas_l, atlas_r):
            if a.device != dev or not a.is_contiguous():
                raise ValueError("atlases must be contiguous, on the rois' "
                                 "device")
        _check_rois(rois_l, rois_r, b, r)
        meta, geom = atlas_meta(level_shapes, torch.stack([rois_l, rois_r]),
                                strides)
        out14l = torch.empty((b, r, PK, PK, c), dtype=torch.float32,
                             device=dev)
        out7l = torch.empty((b, r, P, P, c), dtype=torch.float32, device=dev)
        out7r = torch.empty_like(out7l)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(atlas_l.data_ptr(), atlas_r.data_ptr(),
                     meta[0].data_ptr(), geom[0].data_ptr(),
                     meta[1].data_ptr(), geom[1].data_ptr(),
                     out14l.data_ptr(), out7l.data_ptr(), out7r.data_ptr(),
                     b, r, ah, aw, c, int(dtype == torch.bfloat16), stream)
        self._launched(err)
        return out7l, out7r, out14l


stereo_roi_align_kernel = StereoRoIAlignKernel()
stereo_roi_align_bwd_kernel = StereoRoIAlignBwdKernel()
stereo_roi_align_atlas_kernel = StereoRoIAlignAtlasKernel()


# K1's forward as a registered op, so that ``torch.export`` keeps it as one
# graph node (it cannot trace a ctypes launch on ``data_ptr()``s); at run
# time the node dispatches by device: CUDA tensors to K1, CPU tensors to
# the plain version (looked up by name at each call), other devices raise.
@torch.library.custom_op(
    "stereo_rcnn_tpu_torch::stereo_roi_align_fwd", mutates_args=(),
    device_types="cpu",
    schema="(Tensor[] feats_l, Tensor[] feats_r, Tensor rois_l, "
           "Tensor rois_r, int[] strides, str hat) -> Tensor")
def stereo_roi_align_fwd(feats_l, feats_r, rois_l, rois_r, strides, hat):
    """``[B, R, 294, C]`` float32 for 4 levels a side, ``hat`` one of
    :data:`TOOL_HAT_MODES`."""
    return stereo_roi_align_packed_ref(feats_l, feats_r, rois_l, rois_r,
                                       strides, hat)


@stereo_roi_align_fwd.register_kernel("cuda")
def _stereo_roi_align_fwd_cuda(feats_l, feats_r, rois_l, rois_r, strides,
                               hat):
    return stereo_roi_align_kernel(feats_l, feats_r, rois_l, rois_r, strides,
                                   hat)


@stereo_roi_align_fwd.register_fake
def _stereo_roi_align_fwd_fake(feats_l, feats_r, rois_l, rois_r, strides,
                               hat):
    b, r = rois_l.shape[:2]
    return rois_l.new_empty((b, r, ROWS, feats_l[0].shape[-1]),
                            dtype=torch.float32)


def stereo_roi_align_packed_bwd(g_packed, rois_l, rois_r, level_shapes,
                                strides):
    """The gradient of :func:`stereo_roi_align_packed` w.r.t. the levels,
    float32 (K2 on CUDA tensors, the plain version on CPU tensors)."""
    fn = on_device(g_packed.device, "stereo_roi_align_packed_bwd",
                   stereo_roi_align_bwd_kernel,
                   stereo_roi_align_packed_bwd_ref)
    return fn(g_packed.float().contiguous(), rois_l, rois_r, level_shapes,
              strides)


class _StereoRoIAlign(torch.autograd.Function):
    """Forward K1 (in the given hat mode), backward K2 (the exact f32
    transpose whatever the hat); gradients reach the levels only (cast to
    their dtype), not the rois, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, rois_l, rois_r, strides, hat, *levels):
        n = len(levels) // 2
        feats_l, feats_r = levels[:n], levels[n:]
        ctx.save_for_backward(rois_l, rois_r)
        ctx.strides = strides
        ctx.level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
        ctx.dtypes = [f.dtype for f in levels]
        return torch.ops.stereo_rcnn_tpu_torch.stereo_roi_align_fwd(
            list(feats_l), list(feats_r), rois_l, rois_r, list(strides), hat)

    @staticmethod
    def backward(ctx, g_packed):
        rois_l, rois_r = ctx.saved_tensors
        d_l, d_r = stereo_roi_align_packed_bwd(
            g_packed, rois_l, rois_r, ctx.level_shapes, ctx.strides)
        return (None, None, None, None,
                *[d.to(dt) for d, dt in zip(d_l + d_r, ctx.dtypes)])


def stereo_roi_align_packed(feats_l, feats_r, rois_l, rois_r, strides,
                            hat: str = "f32") -> torch.Tensor:
    """Fused stereo RoIAlign, ``[B, R, 294, C]`` float32, differentiable
    w.r.t. the levels; ``hat`` is one of :data:`HAT_MODES` (others, the
    tool-only ``"bf16"`` and ``"hilo"`` too, raise ``KeyError``, as the JAX
    package's ``_HAT_MODES[hat]`` does).

    CUDA tensors launch the kernels (or raise); CPU tensors take
    :func:`stereo_roi_align_packed_ref` and
    :func:`stereo_roi_align_packed_bwd_ref`.  Any other device raises.
    """
    if hat not in HAT_MODES:
        raise KeyError(hat)
    return _StereoRoIAlign.apply(rois_l, rois_r, tuple(strides), hat,
                                 *feats_l, *feats_r)


def stereo_roi_align_atlas(feats_l, feats_r, rois_l, rois_r, strides):
    """K4: the fused stereo RoIAlign over packed level atlases, batched
    over images.  Levels ``[B, H_l, W_l, C]`` (bf16 or f32), rois
    ``[B, R, 4]``; returns ``(out7l [B, R, 7, 7, C], out7r,
    out14l [B, R, 14, 14, C])`` float32, the JAX entry's outputs per image.
    Not differentiable.  CUDA tensors pack the atlases (a torch copy) and
    launch the kernel once for all images, or raise; CPU tensors take
    :func:`stereo_roi_align_atlas_ref`."""
    fn = on_device(rois_l.device, "stereo_roi_align_atlas", _atlas_on_card,
                   stereo_roi_align_atlas_ref)
    return fn(list(feats_l), list(feats_r), rois_l, rois_r, strides)


def _atlas_on_card(feats_l, feats_r, rois_l, rois_r, strides):
    """Pack both atlases, then one K4 launch for all images."""
    _check_pyramids(feats_l, feats_r, rois_l, rois_r)
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
    return stereo_roi_align_atlas_kernel(
        pack_atlas(feats_l)[0], pack_atlas(feats_r)[0], level_shapes, rois_l,
        rois_r, strides)
