"""One-sided multilevel RoIAlign over a per-roi window: the CUDA kernel
``csrc/roi_align_window.cu`` (K3) and its plain PyTorch version.

Port of ``stereo_rcnn_tpu.ops.roi_align_pallas.multilevel_roi_align_pallas``
and ``roi_align_pallas_single`` (body ``_kernel``).  Each roi is routed to
its FPN level and sampled inside a ``(48, 96)`` window of that level
(clamped to the level), centred on the roi, clamped into the level, its
x origin aligned down to 8; ``P x P`` bins of ``s x s`` bilinear samples
at ``y1 + ((k + 0.5) / s) * roi_h / P``, clamped to the window, averaged.
Unlike the fused stereo kernels, a zero-area roi is not zeroed: its width
and height are clamped to one cell first, and the valid flag is computed
after that clamp (so it is always set), as in the TPU kernel.  Output
``[B, R, P, P, C]`` (or ``[R, P, P, C]``) float32.  No gradient.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from stereo_rcnn_tpu_torch.ops.cuda_build import (CudaKernel, check_levels,
                                                  on_device)
from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (roi_window_meta,
                                                        sample_side,
                                                        window_shapes)

WIN = (48, 96)              # roi_align_pallas.py _WIN_H, _WIN_W
MAX_LEVELS = 5
MAX_SAMPLES = 64            # P * s per axis the kernel takes


def _windows(level_shapes):
    return window_shapes(level_shapes, [WIN] * len(level_shapes))


def roi_align_window_meta(level_shapes, rois: torch.Tensor,
                          strides: Sequence[int], output_size: int):
    """meta int32 ``[..., 4]`` (level, y0, x0, valid) and geom float32
    ``[..., 4]`` (y1, x1, bin_h, bin_w) in window coordinates, as
    ``roi_align_pallas_single`` computes them: the fused kernels' geometry
    over the (48, 96) window, with the valid flag taken after the roi's
    width and height were clamped to >= 1 cell (so always set, as in the
    TPU kernel, unless a coordinate is NaN)."""
    meta, geom = roi_window_meta(level_shapes, rois, strides, output_size,
                                 [WIN] * len(level_shapes))
    meta[..., 3] = ((geom[..., 2] > 0) & (geom[..., 3] > 0)).int()
    return meta, geom


def _batched(feats, rois):
    squeeze = rois.dim() == 2
    if squeeze:
        return [f[None] for f in feats], rois[None], squeeze
    return list(feats), rois, squeeze


def multilevel_roi_align_window_ref(feats, rois, strides, output_size: int,
                                    sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch version of K3: four gathered taps per sample, y first,
    then x, and the mean of each bin's ``s x s`` samples."""
    feats, rois, squeeze = _batched(feats, rois)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    p, s = output_size, sampling_ratio
    level_shapes = [(f.shape[1], f.shape[2]) for f in feats]
    meta, geom = roi_align_window_meta(level_shapes, rois, strides, p)
    samples = sample_side(feats, meta, geom, _windows(level_shapes), p * s, s)
    pooled = samples.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))
    out = torch.where(meta[..., 3, None, None, None] > 0, pooled,
                      torch.zeros((), device=pooled.device))
    return out[0] if squeeze else out


class RoIAlignWindowKernel(CudaKernel):
    """K3: ``roi_align_window_fwd``."""

    source = "roi_align_window.cu"
    symbol = "roi_align_window_fwd"
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def __call__(self, feats, rois, strides, output_size: int,
                 sampling_ratio: int = 2) -> torch.Tensor:
        """Batched form: levels ``[B, H_l, W_l, C]``, rois ``[B, R, 4]``
        float32 -> ``[B, R, P, P, C]`` float32."""
        feats = list(feats)
        dev = rois.device
        p, s = output_size, sampling_ratio
        if not 1 <= len(feats) <= MAX_LEVELS:
            raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, "
                             f"got {len(feats)}")
        if p < 1 or s < 1 or p * s > MAX_SAMPLES:
            raise ValueError(f"output_size * sampling_ratio must be in "
                             f"[1, {MAX_SAMPLES}], got {p} x {s}")
        if rois.dim() != 3 or rois.shape[-1] != 4 or \
                rois.dtype != torch.float32:
            raise ValueError(f"rois must be float32 [B, R, 4], got "
                             f"{rois.dtype} {tuple(rois.shape)}")
        b, r = rois.shape[:2]
        dtype, c = check_levels(feats, dev, b)
        level_shapes = [(f.shape[1], f.shape[2]) for f in feats]
        meta, geom = roi_align_window_meta(level_shapes, rois, strides, p)
        out = torch.empty((b, r, p, p, c), dtype=torch.float32, device=dev)
        n = len(feats)
        ptrs = ctypes.c_void_p * n
        ints = ctypes.c_int * (2 * n)
        self.launch(dev, ptrs(*[f.data_ptr() for f in feats]),
                    ints(*[v for hw in level_shapes for v in hw]),
                    ints(*[v for hw in _windows(level_shapes) for v in hw]),
                    n, meta.data_ptr(), geom.data_ptr(), out.data_ptr(),
                    b, r, c, p, s, int(dtype == torch.bfloat16))
        return out


roi_align_window_kernel = RoIAlignWindowKernel()


def multilevel_roi_align_window(feats, rois, strides, output_size: int,
                                sampling_ratio: int = 2) -> torch.Tensor:
    """Windowed multilevel RoIAlign (the counterpart of the JAX package's
    ``multilevel_roi_align_pallas``): levels ``[B, H_l, W_l, C]`` with rois
    ``[B, R, 4]``, or ``[H_l, W_l, C]`` with ``[R, 4]``.  CUDA tensors
    launch K3 (or raise); CPU tensors take
    :func:`multilevel_roi_align_window_ref`."""
    fn = on_device(rois.device, "multilevel_roi_align_window",
                   _window_on_card, multilevel_roi_align_window_ref)
    return fn(feats, rois, strides, output_size, sampling_ratio)


def _window_on_card(feats, rois, strides, output_size, sampling_ratio):
    feats, rois, squeeze = _batched(feats, rois)
    out = roi_align_window_kernel(feats, rois,
                                  strides, output_size, sampling_ratio)
    return out[0] if squeeze else out
