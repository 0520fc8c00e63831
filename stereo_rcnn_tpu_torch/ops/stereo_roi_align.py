"""Fused stereo RoIAlign: the CUDA kernel ``csrc/stereo_roi_align.cu`` and
its plain PyTorch version.

Port of ``stereo_rcnn_tpu.ops.roi_align_pallas.stereo_roi_align_batched_packed``
with ``hat="f32"``.  Per image and roi it returns one packed block of
``294 x C`` float32 rows: 196 left 14x14 samples (keypoint branch), the
left 7x7 pool (their 2x2 means), the right 7x7 pool (the 2x2 means of the
same grid on the right features).  Levels P2..P5 are NHWC
``[B, H_l, W_l, C]``; rois are ``[B, R, 4]`` xyxy float32 in image
coordinates.

:func:`roi_window_meta` computes the level, window and sample geometry on
the tensors' device; the kernel and :func:`stereo_roi_align_packed_ref`
both read it, so they never disagree on a level or window.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from stereo_rcnn_tpu_torch.ops.roi_align import fpn_level_assignment

# Per-level sampling windows of the TPU kernel (roi_align_pallas.py
# _STEREO_WIN), clamped to each level; samples are clamped to the window.
STEREO_WIN = ((48, 64), (48, 64), (24, 64), (12, 40))
PK = 14                     # kpt samples per axis
P = 7                       # pooled bins per axis
ROWS = PK * PK + 2 * P * P  # 294


def window_shapes(level_shapes):
    return [(min(h, bh), min(w, bw))
            for (h, w), (bh, bw) in zip(level_shapes, STEREO_WIN)]


def roi_window_meta(level_shapes, rois: torch.Tensor,
                    strides: Sequence[int], ps: int = PK):
    """meta int32 ``[..., 4]`` (level, y0, x0, valid) and geom float32
    ``[..., 4]`` (y1, x1, bin_h, bin_w) in window coordinates; window
    origins are 8-aligned on the W axis as in the TPU kernel."""
    levels = fpn_level_assignment(rois, len(level_shapes))
    # One small table per call: each host-to-device copy syncs the stream.
    table = torch.tensor(
        [[1.0 / s, h, w, wh, ww] for s, (h, w), (wh, ww)
         in zip(strides, level_shapes, window_shapes(level_shapes))],
        dtype=torch.float32, device=rois.device)[levels]
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
# Plain PyTorch version.
# ---------------------------------------------------------------------------

def _sample_side(feats, meta, geom, win, n: int) -> torch.Tensor:
    """[B, R, n, n, C] float32 bilinear samples of one side: 4 gathered taps
    per sample from the level atlas, weighted y first, then x."""
    b, r = meta.shape[:2]
    c = feats[0].shape[-1]
    dev = meta.device
    level = meta[..., 0].long()
    origin_y = meta[..., 1:2].float()
    origin_x = meta[..., 2:3].float()
    win_h = torch.tensor([h for h, _ in win], dtype=torch.float32,
                         device=dev)[level][..., None]
    win_w = torch.tensor([w for _, w in win], dtype=torch.float32,
                         device=dev)[level][..., None]
    grid = torch.arange(n, dtype=torch.float32, device=dev) + 0.5
    ys = torch.minimum(torch.clamp(geom[..., 0:1] + grid * geom[..., 2:3],
                                   min=0.0), win_h - 1.0)      # [B, R, n]
    xs = torch.minimum(torch.clamp(geom[..., 1:2] + grid * geom[..., 3:4],
                                   min=0.0), win_w - 1.0)
    y_lo, x_lo = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y_lo, xs - x_lo
    y_hi = torch.minimum(y_lo + 1.0, win_h - 1.0) + origin_y
    x_hi = torch.minimum(x_lo + 1.0, win_w - 1.0) + origin_x
    y_lo, x_lo = y_lo + origin_y, x_lo + origin_x

    sizes = [f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           device=dev)[level][..., None, None]
    lvl_w = torch.tensor([f.shape[2] for f in feats],
                         device=dev)[level][..., None, None]
    atlas = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1)
    bidx = torch.arange(b, device=dev)[:, None]

    def tap(rows, cols):
        idx = (offsets + rows.long()[..., :, None] * lvl_w +
               cols.long()[..., None, :])                       # [B, R, n, n]
        return atlas[bidx, idx.reshape(b, -1)].float().reshape(
            b, r, n, n, c)

    wyl, wyh = (1.0 - fy)[..., :, None, None], fy[..., :, None, None]
    wxl, wxh = (1.0 - fx)[..., None, :, None], fx[..., None, :, None]
    t0 = wyl * tap(y_lo, x_lo) + wyh * tap(y_hi, x_lo)
    t1 = wyl * tap(y_lo, x_hi) + wyh * tap(y_hi, x_hi)
    return wxl * t0 + wxh * t1


def stereo_roi_align_packed_ref(feats_l, feats_r, rois_l, rois_r,
                                strides) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[B, R, 294, C]`` float32."""
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
    win = window_shapes(level_shapes)
    b, r = rois_l.shape[:2]
    c = feats_l[0].shape[-1]
    meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
    meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
    left = _sample_side(feats_l, meta_l, geom_l, win, PK)
    right = _sample_side(feats_r, meta_r, geom_r, win, PK)
    pool_l = left.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    pool_r = right.reshape(b, r, P, 2, P, 2, c).mean(dim=(3, 5))
    ok_l = meta_l[..., 3:4, None] > 0
    ok_r = meta_r[..., 3:4, None] > 0
    zero = torch.zeros((), dtype=torch.float32, device=left.device)
    return torch.cat([
        torch.where(ok_l, left.reshape(b, r, PK * PK, c), zero),
        torch.where(ok_l, pool_l.reshape(b, r, P * P, c), zero),
        torch.where(ok_r, pool_r.reshape(b, r, P * P, c), zero)], dim=2)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------

class StereoRoIAlignKernel:
    """ctypes binding of ``stereo_roi_align_fwd``, built at first use.

    ``launches`` counts kernel launches; it grows in :meth:`__call__` only.
    """

    source = "stereo_roi_align.cu"

    def __init__(self):
        self.launches = 0
        self.build_info = None
        self._fn = None

    def load(self):
        if self._fn is None:
            from stereo_rcnn_tpu_torch.ops.cuda_build import load_library
            lib, self.build_info = load_library(self.source)
            fn = lib.stereo_roi_align_fwd
            p = ctypes.c_void_p
            fn.argtypes = [p, p, p, p, p, p, p, p, p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, feats_l, feats_r, rois_l, rois_r,
                 strides) -> torch.Tensor:
        fn = self.load()
        feats_l, feats_r = list(feats_l), list(feats_r)
        dev = rois_l.device
        if len(feats_l) != 4 or len(feats_r) != 4:
            raise ValueError("the kernel takes exactly 4 levels (P2..P5) "
                             "per side")
        dtype = feats_l[0].dtype
        if dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"features must be bfloat16 or float32, "
                            f"got {dtype}")
        b, r = rois_l.shape[:2]
        c = feats_l[0].shape[-1]
        if c % 2:
            raise ValueError(f"channel count must be even, got {c}")
        for f_l, f_r in zip(feats_l, feats_r):
            for f in (f_l, f_r):
                if f.device != dev or f.dtype != dtype:
                    raise ValueError("all levels must share the rois' "
                                     "device and one dtype")
                if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
                    raise ValueError(f"level shape {tuple(f.shape)} is not "
                                     f"[{b}, H, W, {c}]")
                if not f.is_contiguous():
                    raise ValueError("levels must be contiguous NHWC")
            if f_l.shape != f_r.shape:
                raise ValueError("left and right pyramids differ in shape")
        for rois in (rois_l, rois_r):
            if rois.shape != (b, r, 4) or rois.dtype != torch.float32:
                raise ValueError("rois must be float32 [B, R, 4], got "
                                 f"{rois.dtype} {tuple(rois.shape)}")
        level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
        meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
        meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
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
                     meta_l.data_ptr(), geom_l.data_ptr(),
                     meta_r.data_ptr(), geom_r.data_ptr(), out.data_ptr(),
                     b, r, c, int(dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"stereo_roi_align_fwd launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out


stereo_roi_align_kernel = StereoRoIAlignKernel()


def stereo_roi_align_packed(feats_l, feats_r, rois_l, rois_r,
                            strides) -> torch.Tensor:
    """Fused stereo RoIAlign, ``[B, R, 294, C]`` float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`stereo_roi_align_packed_ref`.  Any other device raises.
    """
    dev = rois_l.device
    if dev.type == "cuda":
        return stereo_roi_align_kernel(feats_l, feats_r, rois_l, rois_r,
                                       strides)
    if dev.type == "cpu":
        return stereo_roi_align_packed_ref(feats_l, feats_r, rois_l, rois_r,
                                           strides)
    raise RuntimeError(f"stereo_roi_align_packed: no implementation for "
                       f"device {dev}")
