"""The end-to-end inference path: network -> decode/NMS -> 3D solve ->
dense alignment -> z-fixed re-solve (torch).

Port of ``stereo_rcnn_tpu.inference``.  The JAX package vmaps the solve
over images with a per-image calibration; here the [B, D] detections are
flattened to one [B*D] solve with the calibration repeated per detection,
which is the same arithmetic per detection.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from h100_bench.reference.config import Config
from h100_bench.reference.device import resolve_device
from h100_bench.reference.geometry.calib import StereoCalib
from h100_bench.reference.models.detector import Detections, make_inference_fn
from h100_bench.reference.precision import stage_input
from h100_bench.reference.solve.box_estimator import (
    _observe_jac, observations_from_detection, solve_batch)
from h100_bench.reference.solve.dense_align import align_batch


class Detections3D(NamedTuple):
    """2D detections + solved 3D boxes, padded [B, D, ...]."""

    det: Detections
    position: torch.Tensor   # [B, D, 3] (x, y, z) bottom-center
    ry: torch.Tensor         # [B, D] yaw
    z_refined: torch.Tensor  # [B, D] dense-alignment depth
    residual: torch.Tensor   # [B, D] solver residual (px)


def broadcast_calib(calib: StereoCalib, batch: int,
                    device: torch.device | str | None = None) -> StereoCalib:
    """Tile a single working-resolution calib to [B]-leading float32
    tensors on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    return StereoCalib(*[
        torch.from_numpy(np.asarray(v, np.float32)).to(device).expand(
            (batch,) + np.shape(v)).contiguous() for v in calib])


def truncation_weights(box_left: torch.Tensor, box_right: torch.Tensor,
                       kpt_u: torch.Tensor, kpt_prob: torch.Tensor,
                       content_w, content_h, eps: float = 1.5):
    """Per-observation solver weights [..., 7] for columns (ul, v_top, ur,
    v_bottom, ul_r, ur_r, u_kpt): a box edge at the content border, or a
    low-confidence or border keypoint, drops its own constraint."""
    bl, br = box_left, box_right
    drop = [
        bl[..., 0] <= eps,                       # ul (left image)
        bl[..., 1] <= eps,                       # v_top
        bl[..., 2] >= content_w - 1.0 - eps,     # ur (left image)
        bl[..., 3] >= content_h - 1.0 - eps,     # v_bottom
        br[..., 0] <= eps,                       # ul (right image)
        br[..., 2] >= content_w - 1.0 - eps,     # ur (right image)
        ~((kpt_prob > 0.2) & (kpt_u > eps) & (kpt_u < content_w - 1.0 - eps)),
    ]
    return 1.0 - torch.stack(drop, dim=-1).float()


def solve_and_align(det: Detections, images_left: torch.Tensor,
                    images_right: torch.Tensor, calib_batch: StereoCalib,
                    cfg: Config,
                    content_wh: torch.Tensor | None = None) -> Detections3D:
    """Batched 3D solve + dense alignment + z-fixed re-solve.

    ``calib_batch`` fields are [B] tensors; ``content_wh`` ([B, 2]) is the
    letterboxed content extent (None: the content fills the canvas).
    """
    sc = cfg.solver
    b, im_h, im_w = images_left.shape[:3]
    d = det.valid.shape[1]
    dev = images_left.device
    answered, det = det, Detections(*[stage_input(x) for x in det])
    images_left = stage_input(images_left)
    images_right = stage_input(images_right)
    if content_wh is None:
        content_wh = torch.tensor([float(im_w), float(im_h)],
                                  device=dev).expand(b, 2)
    gray_l = images_left.mean(-1)
    gray_r = images_right.mean(-1)

    def flat(x):
        return x.reshape(b * d, *x.shape[2:])

    per_det = StereoCalib(*[v.repeat_interleave(d, dim=0)
                            for v in calib_batch])           # [B*D]
    obs = observations_from_detection(flat(det.box_left),
                                      flat(det.box_right), flat(det.kpt_u))
    w = truncation_weights(det.box_left, det.box_right, det.kpt_u,
                           det.kpt_prob, content_wh[:, 0:1],
                           content_wh[:, 1:2])
    args = (obs, flat(det.dims), flat(det.alpha), flat(det.kpt_type),
            per_det)
    kw = dict(obs_weights=flat(w), iters=sc.gn_iters, damping=sc.gn_damping)
    res = solve_batch(*args, **kw)
    ar = align_batch(gray_l, gray_r, det.box_left, det.border_u,
                     res.position.reshape(b, d, 3), res.theta.reshape(b, d),
                     det.dims, calib_batch, sc, det.valid)
    res2 = solve_batch(*args, fixed_z=flat(ar.z), **kw)
    return Detections3D(det=answered,
                        position=res2.position.reshape(b, d, 3),
                        ry=res2.theta.reshape(b, d), z_refined=ar.z,
                        residual=res2.residual.reshape(b, d))


def judge_3d(det: Detections, images_left: torch.Tensor,
             images_right: torch.Tensor, calib_batch: StereoCalib,
             cfg: Config, position: torch.Tensor, ry: torch.Tensor,
             z_refined: torch.Tensor):
    """How well another program's 3D answers ``position``, ``ry`` and
    ``z_refined`` ([B, D, ...]) fit its own 2D detections ``det``, by the
    objectives of :func:`solve_and_align`: ``(solve_px, align_rel, ok)``.

    ``align_rel``: how far the dense alignment's photometric error at
    ``z_refined`` lies above the least error this reference's sweep finds
    (from its own solve of ``det``), as a share of the latter.
    ``solve_px``: how far the solver's RMS residual at ``position``/``ry``
    lies above the residual of this reference's z-fixed re-solve at the
    same ``z_refined``.  Both count only a shortfall: an answer that fits
    better than the reference's own (a depth its sweep did not reach, a
    lower minimum) is no error.  ``ok``:
    the valid detections whose alignment ran.  Near-ties in the sweep or
    flat directions of the solve cost nothing here."""
    sc = cfg.solver
    b, im_h, im_w = images_left.shape[:3]
    d = det.valid.shape[1]
    dev = images_left.device
    content_wh = torch.tensor([float(im_w), float(im_h)],
                              device=dev).expand(b, 2)

    def flat(x):
        return x.reshape(b * d, *x.shape[2:])

    per_det = StereoCalib(*[v.repeat_interleave(d, dim=0)
                            for v in calib_batch])
    obs = observations_from_detection(flat(det.box_left),
                                      flat(det.box_right), flat(det.kpt_u))
    w = flat(truncation_weights(det.box_left, det.box_right, det.kpt_u,
                                det.kpt_prob, content_wh[:, 0:1],
                                content_wh[:, 1:2]))
    args = (obs, flat(det.dims), flat(det.alpha), flat(det.kpt_type),
            per_det)
    kw = dict(obs_weights=w, iters=sc.gn_iters, damping=sc.gn_damping)
    res = solve_batch(*args, **kw)
    ar, err_probe = align_batch(
        images_left.mean(-1), images_right.mean(-1), det.box_left,
        det.border_u, res.position.reshape(b, d, 3),
        res.theta.reshape(b, d), det.dims, calib_batch, sc, det.valid,
        probe_z=z_refined)
    ok = det.valid & torch.isfinite(ar.error)
    align_rel = torch.where(
        ok, torch.clamp(err_probe / torch.clamp(ar.error, min=1e-6) - 1.0,
                        min=0.0), torch.zeros_like(ar.error))
    res2 = solve_batch(*args, fixed_z=flat(z_refined), **kw)
    state = torch.cat([flat(position), flat(ry)[:, None]], dim=1)
    pred, _ = _observe_jac(state, flat(det.dims), flat(det.kpt_type),
                           per_det)
    rms = torch.sqrt(torch.mean(((pred - obs) * w) ** 2, dim=-1))
    solve_px = torch.clamp(rms - res2.residual, min=0.0).reshape(b, d)
    return (torch.where(det.valid, solve_px, torch.zeros_like(solve_px)),
            align_rel, ok)


def make_full_pipeline(cfg: Config, calib: StereoCalib | None = None,
                       im_h: int | None = None, im_w: int | None = None):
    """The end-to-end pipeline.

    With ``calib`` (one working-resolution calibration):
    ``fn(model, left, right) -> Detections3D``.  Without it:
    ``fn(model, left, right, calib_batch, content_wh=None)`` with [B]
    calibration tensors (see :func:`broadcast_calib`).
    """
    infer = make_inference_fn(cfg, im_h, im_w)

    @torch.no_grad()
    def fn_calib(model, images_left, images_right, calib_batch: StereoCalib,
                 content_wh: torch.Tensor | None = None,
                 evidence: dict | None = None) -> Detections3D:
        det = infer(model, images_left, images_right, evidence)
        return solve_and_align(det, images_left, images_right, calib_batch,
                               cfg, content_wh)

    if calib is None:
        return fn_calib

    def fn(model, images_left, images_right,
           evidence: dict | None = None) -> Detections3D:
        cb = broadcast_calib(calib, images_left.shape[0], images_left.device)
        return fn_calib(model, images_left, images_right, cb,
                        evidence=evidence)

    return fn
