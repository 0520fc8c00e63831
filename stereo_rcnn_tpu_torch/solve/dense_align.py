"""Dense left-right photometric alignment for depth refinement (torch).

Port of ``stereo_rcnn_tpu.solve.dense_align``: per detection, sweep
candidate depths around the solved z (coarse, then fine), warp the lower
half of the visible span of the left box into the right image through the
per-column disparity of the solved box surface, and keep the depth with
the least mean absolute photometric error.  Image sampling is written as
products with linear-interpolation "hat" matrices that clamp at the edges,
``W[k, i] = max(0, 1 - |i - clip(pos_k)|)``, in the JAX package's einsum
form, so it lands on ``torch.einsum`` / matmul.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_rcnn_tpu_torch.config import SolverConfig
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib

# Strip width: horizontal resampling resolution of the right strip.
STRIP_SIZE = 256


class AlignResult(NamedTuple):
    z: torch.Tensor        # [B, D] refined depth
    error: torch.Tensor    # [B, D] photometric error at the optimum


def _hat(positions: torch.Tensor, size: int) -> torch.Tensor:
    """Linear-interpolation weight rows [..., size], positions clamped to
    the valid range."""
    pos = torch.clamp(positions, 0.0, size - 1.0)
    iota = torch.arange(size, dtype=positions.dtype, device=positions.device)
    return torch.clamp(1.0 - torch.abs(iota - pos[..., None]), min=0.0)


def _visible_depth_profile(us, position, dims_hwl, theta,
                           calib: StereoCalib) -> torch.Tensor:
    """Depth z(u) [B, D, W] of the visible box surface per sampled column,
    by ray-rectangle intersection in bird's-eye view; misses fall back to
    the center depth.  ``calib`` fields are [B, 1] (or numbers)."""
    x = position[..., 0:1]
    z = position[..., 2:3]
    w_half = dims_hwl[..., 1:2] / 2
    l_half = dims_hwl[..., 2:3] / 2
    s = (us - calib.cu[..., None]) / calib.f[..., None]
    c = torch.cos(theta)[..., None]
    si = torch.sin(theta)[..., None]
    o_x = -calib.tx2[..., None] - x
    o_z = -z
    a1 = c * s - si
    b1 = c * o_x - si * o_z
    a2 = si * s + c
    b2 = si * o_x + c * o_z

    def slab(a, b, half):
        big = 1e9
        tiny = torch.abs(a) < 1e-9
        safe_a = torch.where(tiny, torch.ones_like(a), a)
        t1 = (-half - b) / safe_a
        t2 = (half - b) / safe_a
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        inside = torch.abs(b) <= half
        lo = torch.where(tiny, torch.where(inside, -big, big), lo)
        hi = torch.where(tiny, torch.where(inside, big, -big), hi)
        return lo, hi

    lo1, hi1 = slab(a1, b1, l_half)
    lo2, hi2 = slab(a2, b2, w_half)
    t_enter = torch.maximum(lo1, lo2)
    t_exit = torch.minimum(hi1, hi2)
    hit = (t_enter <= t_exit) & (t_enter > 0.1)
    return torch.where(hit, t_enter, z)


def align_batch(left_gray: torch.Tensor, right_gray: torch.Tensor,
                box_left: torch.Tensor, border_u: torch.Tensor,
                position: torch.Tensor, theta: torch.Tensor,
                dims_hwl: torch.Tensor, calib: StereoCalib,
                cfg: SolverConfig, valid: torch.Tensor) -> AlignResult:
    """Refine depths for [B, D] detections.

    left_gray/right_gray [B, H, W]; box_left [B, D, 4]; border_u [B, D, 2];
    position [B, D, 3], theta [B, D], dims_hwl [B, D, 3]: the solved pose;
    calib fields [B]; valid [B, D] — invalid detections keep their z.
    """
    b, im_h, im_w = left_gray.shape
    dev = left_gray.device
    gh, gw = cfg.align_grid_h, cfg.align_grid_w
    cal = StereoCalib(*[v[:, None] if torch.is_tensor(v) else v
                        for v in calib])                      # [B, 1]

    z0 = position[..., 2]                                     # [B, D]
    b_lo = torch.minimum(border_u[..., 0], border_u[..., 1])
    b_hi = torch.maximum(border_u[..., 0], border_u[..., 1])
    u_lo = torch.maximum(box_left[..., 0], b_lo)
    u_hi = torch.minimum(box_left[..., 2], b_hi)
    u_lo, u_hi = torch.minimum(u_lo, u_hi), torch.maximum(u_lo, u_hi)
    v_lo = 0.5 * (box_left[..., 1] + box_left[..., 3])
    v_hi = box_left[..., 3]
    degenerate = (u_hi - u_lo) < 2.0

    gu = (torch.arange(gw, device=dev) + 0.5) / gw
    gv = (torch.arange(gh, device=dev) + 0.5) / gh
    us = u_lo[..., None] + gu * (u_hi - u_lo)[..., None]      # [B, D, gw]
    vs = v_lo[..., None] + gv * (v_hi - v_lo)[..., None]      # [B, D, gh]

    dz = _visible_depth_profile(us, position, dims_hwl, theta,
                                cal) - z0[..., None]          # [B, D, gw]
    fb = cal.f * cal.baseline                                 # [B, 1]

    # Left reference patch and right strip, each pixel touched once.
    rv = _hat(vs, im_h)                                       # [B, D, gh, H]
    rows_l = torch.einsum("bdvh,bhw->bdvw", rv, left_gray)
    cu_l = _hat(us, im_w)                                     # [B, D, gw, W]
    ref = torch.einsum("bdvw,bdjw->bdvj", rows_l, cu_l)       # [B, D, gh, gw]

    span = cfg.align_coarse_range + cfg.align_fine_range
    z_min = torch.clamp(z0 - span + dz.amin(-1), min=0.5)
    z_max = torch.clamp(z0 + span + dz.amax(-1), min=0.6)
    d_hi = fb / z_min                                         # [B, D]
    d_lo = fb / z_max
    strip_lo = u_lo - d_hi
    strip_hi = u_hi - d_lo + 1.0
    strip_step = (strip_hi - strip_lo) / STRIP_SIZE
    u_strip = strip_lo[..., None] + (
        torch.arange(STRIP_SIZE, device=dev) + 0.5) * strip_step[..., None]
    rows_r = torch.einsum("bdvh,bhw->bdvw", rv, right_gray)
    cu_s = _hat(u_strip, im_w)                                # [B, D, S, W]
    strip = torch.einsum("bdvw,bdkw->bdvk", rows_r, cu_s)     # [B, D, gh, S]

    def sweep(centers: torch.Tensor, offsets: torch.Tensor):
        cand = centers[..., None] + offsets                   # [B, D, C]
        z_cols = cand[..., None] + dz[..., None, :]           # [B, D, C, gw]
        disp = fb[..., None, None] / torch.clamp(z_cols, min=0.5)
        u_r = us[..., None, :] - disp
        idx = (u_r - strip_lo[..., None, None]) / \
            strip_step[..., None, None] - 0.5                 # strip coords
        wc = _hat(idx, STRIP_SIZE)                            # [B,D,C,gw,S]
        warped = torch.einsum("bdvk,bdcjk->bdcvj", strip, wc)
        err = torch.abs(warped - ref[:, :, None]).mean((-1, -2))  # [B, D, C]
        best = torch.argmin(err, dim=-1, keepdim=True)
        return (torch.gather(cand, -1, best)[..., 0],
                torch.gather(err, -1, best)[..., 0])

    coarse = torch.linspace(-cfg.align_coarse_range, cfg.align_coarse_range,
                            cfg.align_coarse_candidates, device=dev)
    z1, _ = sweep(z0, coarse)
    fine = torch.linspace(-cfg.align_fine_range, cfg.align_fine_range,
                          cfg.align_fine_candidates, device=dev)
    z2, err2 = sweep(z1, fine)

    ok = valid & ~degenerate & (z0 > 0.5)
    return AlignResult(z=torch.where(ok, z2, z0),
                       error=torch.where(ok, err2,
                                         torch.full_like(err2, torch.inf)))


def align_depth(left_gray: torch.Tensor, right_gray: torch.Tensor,
                box_left: torch.Tensor, border_u: torch.Tensor,
                position: torch.Tensor, theta, dims_hwl: torch.Tensor,
                calib: StereoCalib, cfg: SolverConfig,
                valid) -> AlignResult:
    """One detection on one pair ([H, W] images, box [4], border [2],
    position [3], dims [3], scalar theta and valid) through
    :func:`align_batch`; ``calib`` holds one calibration (numbers or 0-d
    tensors)."""
    dev = left_gray.device
    cal = StereoCalib(*[torch.as_tensor(v, dtype=torch.float32,
                                        device=dev)[None] for v in calib])
    res = align_batch(
        left_gray[None], right_gray[None], box_left[None, None],
        border_u[None, None], position[None, None],
        torch.as_tensor(theta, dtype=position.dtype, device=dev)[None, None],
        dims_hwl[None, None], cal, cfg,
        torch.as_tensor(valid, dtype=torch.bool, device=dev)[None, None])
    return AlignResult(z=res.z[0, 0], error=res.error[0, 0])
