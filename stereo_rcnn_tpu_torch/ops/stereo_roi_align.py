"""Fused stereo RoIAlign and its gradient: the CUDA kernels
``csrc/stereo_roi_align.cu`` (K1, forward) and
``csrc/stereo_roi_align_bwd.cu`` (K2, backward), and their plain PyTorch
versions.

Port of ``stereo_rcnn_tpu.ops.roi_align_pallas.stereo_roi_align_batched_packed``
with ``hat="f32"`` and its custom VJP.  Per image and roi the forward
returns one packed block of ``294 x C`` float32 rows: 196 left 14x14
samples (keypoint branch), the left 7x7 pool (their 2x2 means), the right
7x7 pool (the 2x2 means of the same grid on the right features).  Levels
P2..P5 are NHWC ``[B, H_l, W_l, C]``; rois are ``[B, R, 4]`` xyxy float32
in image coordinates.  The backward scatters a packed cotangent back
through the same bilinear taps into float32 per-level gradients, cast to
the features' dtype; the rois get no gradient.

:func:`roi_window_meta` computes the level, window and sample geometry on
the tensors' device; the kernels and the plain versions all read it, so
they never disagree on a level or window.
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

def _taps(meta, geom, win, n: int):
    """Bilinear taps of a side's n x n sample grid, each [B, R, n]: the
    absolute level rows ``y_lo``/``y_hi`` and columns ``x_lo``/``x_hi``
    and the fractions ``fy``/``fx`` (weights 1 - f on lo, f on hi).
    Samples are clamped to the window; ``hi`` is ``min(lo + 1, win - 1)``."""
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
    return y_lo + origin_y, y_hi, x_lo + origin_x, x_hi, fy, fx


def _atlas_index(level_shapes, meta):
    """``index(rows, cols) -> [B, R, n, n]`` row indices into the levels of
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


def _sample_side(feats, meta, geom, win, n: int) -> torch.Tensor:
    """[B, R, n, n, C] float32 bilinear samples of one side: 4 gathered taps
    per sample from the level atlas, weighted y first, then x."""
    b, r = meta.shape[:2]
    c = feats[0].shape[-1]
    y_lo, y_hi, x_lo, x_hi, fy, fx = _taps(meta, geom, win, n)
    index = _atlas_index([(f.shape[1], f.shape[2]) for f in feats], meta)
    atlas = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1)
    atlas = atlas.reshape(-1, c)

    def tap(rows, cols):
        return atlas[index(rows, cols)].float()          # [B, R, n, n, C]

    wyl, wyh = (1.0 - fy)[..., :, None, None], fy[..., :, None, None]
    wxl, wxh = (1.0 - fx)[..., None, :, None], fx[..., None, :, None]
    t0 = wyl * tap(y_lo, x_lo) + wyh * tap(y_hi, x_lo)
    t1 = wyl * tap(y_lo, x_hi) + wyh * tap(y_hi, x_hi)
    return wxl * t0 + wxh * t1


def _tap_contributions(g_samples, meta, geom, win, level_shapes, n: int):
    """Transpose of :func:`_sample_side` as scatter operands: for each of
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


class _CudaKernel:
    """ctypes binding of one C entry of a ``csrc/`` source, built at first
    use.  ``launches`` counts kernel launches; it grows in ``__call__``
    only, right after a launch that returned no error."""

    source = ""
    symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.build_info = None
        self._fn = None

    def load(self):
        if self._fn is None:
            from stereo_rcnn_tpu_torch.ops.cuda_build import load_library
            lib, self.build_info = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launched(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int


class StereoRoIAlignKernel(_CudaKernel):
    """K1: ``stereo_roi_align_fwd`` (the forward)."""

    source = "stereo_roi_align.cu"
    symbol = "stereo_roi_align_fwd"
    argtypes = [_P] * 9 + [_I] * 4 + [_P]

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
        _check_rois(rois_l, rois_r, b, r)
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
        self._launched(err)
        return out


class StereoRoIAlignBwdKernel(_CudaKernel):
    """K2: ``stereo_roi_align_bwd`` (the backward)."""

    source = "stereo_roi_align_bwd.cu"
    symbol = "stereo_roi_align_bwd"
    argtypes = [_P] * 9 + [_I] * 3 + [_P]

    def __call__(self, g_packed, rois_l, rois_r, level_shapes, strides):
        """float32 ``(d_feats_l, d_feats_r)`` lists of ``[B, H_l, W_l, C]``
        for the packed cotangent ``g_packed`` [B, R, 294, C] float32."""
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
        meta_l, geom_l = roi_window_meta(level_shapes, rois_l, strides)
        meta_r, geom_r = roi_window_meta(level_shapes, rois_r, strides)
        d_l = [torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
               for h, w in level_shapes]
        d_r = [torch.zeros_like(d) for d in d_l]
        ptrs = ctypes.c_void_p * 4
        ints = ctypes.c_int * 8
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ptrs(*[d.data_ptr() for d in d_l]),
                     ptrs(*[d.data_ptr() for d in d_r]),
                     ints(*[v for hw in level_shapes for v in hw]),
                     ints(*[v for hw in window_shapes(level_shapes)
                            for v in hw]),
                     meta_l.data_ptr(), geom_l.data_ptr(),
                     meta_r.data_ptr(), geom_r.data_ptr(),
                     g_packed.data_ptr(), b, r, c, stream)
        self._launched(err)
        return d_l, d_r


stereo_roi_align_kernel = StereoRoIAlignKernel()
stereo_roi_align_bwd_kernel = StereoRoIAlignBwdKernel()


def _on(dev: torch.device, name: str, cuda_fn, cpu_fn):
    """CUDA tensors take the kernel, CPU tensors the plain version; any
    other device raises."""
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return cpu_fn
    raise RuntimeError(f"{name}: no implementation for device {dev}")


def stereo_roi_align_packed_bwd(g_packed, rois_l, rois_r, level_shapes,
                                strides):
    """The gradient of :func:`stereo_roi_align_packed` w.r.t. the levels,
    float32 (K2 on CUDA tensors, the plain version on CPU tensors)."""
    fn = _on(g_packed.device, "stereo_roi_align_packed_bwd",
             stereo_roi_align_bwd_kernel, stereo_roi_align_packed_bwd_ref)
    return fn(g_packed.float().contiguous(), rois_l, rois_r, level_shapes,
              strides)


class _StereoRoIAlign(torch.autograd.Function):
    """Forward K1, backward K2; gradients reach the levels only (cast to
    their dtype), not the rois, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, rois_l, rois_r, strides, *levels):
        n = len(levels) // 2
        feats_l, feats_r = levels[:n], levels[n:]
        ctx.save_for_backward(rois_l, rois_r)
        ctx.strides = strides
        ctx.level_shapes = [(f.shape[1], f.shape[2]) for f in feats_l]
        ctx.dtypes = [f.dtype for f in levels]
        fn = _on(rois_l.device, "stereo_roi_align_packed",
                 stereo_roi_align_kernel, stereo_roi_align_packed_ref)
        return fn(feats_l, feats_r, rois_l, rois_r, strides)

    @staticmethod
    def backward(ctx, g_packed):
        rois_l, rois_r = ctx.saved_tensors
        d_l, d_r = stereo_roi_align_packed_bwd(
            g_packed, rois_l, rois_r, ctx.level_shapes, ctx.strides)
        return (None, None, None,
                *[d.to(dt) for d, dt in zip(d_l + d_r, ctx.dtypes)])


def stereo_roi_align_packed(feats_l, feats_r, rois_l, rois_r,
                            strides) -> torch.Tensor:
    """Fused stereo RoIAlign, ``[B, R, 294, C]`` float32, differentiable
    w.r.t. the levels.

    CUDA tensors launch the kernels (or raise); CPU tensors take
    :func:`stereo_roi_align_packed_ref` and
    :func:`stereo_roi_align_packed_bwd_ref`.  Any other device raises.
    """
    return _StereoRoIAlign.apply(rois_l, rois_r, tuple(strides),
                                 *feats_l, *feats_r)
