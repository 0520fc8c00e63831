"""Fixed-shape training target assignment, batched over images (torch).

Port of ``stereo_rcnn_tpu.train.targets``: RPN anchor targets (IoU against
the union of each GT pair, a 256-anchor sample with at most half
foreground) and second-stage proposal targets (128 RoIs per image, GT
pairs appended to the proposals, class / stereo box / dims / viewpoint /
keypoint targets).  The JAX package vmaps one image; here every function
takes a leading batch axis.

Sampling without replacement is the JAX package's random-priority top-k:
eligible entries get a uniform priority, the rest ``-inf``, and the top k
are kept.  The uniforms are arguments (:class:`Uniforms`), drawn from a
``torch.Generator`` by :func:`draw_uniforms`; a test hands in the ones
``jax.random`` draws instead.  Ties order by index, as ``lax.top_k`` and
``jnp.argsort`` do (``top_k_stable``, stable sorts; never ``torch.topk``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_rcnn_tpu_torch.config import RCNNConfig, RPNConfig
from stereo_rcnn_tpu_torch.geometry.boxes import (encode_stereo_boxes,
                                                  pairwise_iou, union_box)
from stereo_rcnn_tpu_torch.models.stereo_rpn import take_per_image
from stereo_rcnn_tpu_torch.ops.nms import top_k_stable


class GroundTruth(NamedTuple):
    """Per-image padded ground truth (leading dims [..., G]).

    Slots are one of three kinds:
      * real objects: ``valid=True, ignore=False`` — drive all losses;
      * ignore regions (DontCare/Van/Truck for the Car class):
        ``valid=False, ignore=True`` — anchors/rois overlapping them are
        EXCLUDED from negative sampling;
      * padding: ``valid=False, ignore=False`` — inert.
    """

    left: torch.Tensor        # [G, 4] left-image boxes
    right: torch.Tensor       # [G, 4] right-image boxes
    cls: torch.Tensor         # [G] int class (1 = Car)
    dims: torch.Tensor        # [G, 3] (h, w, l) metres
    alpha: torch.Tensor       # [G] viewpoint angle
    kpt_u: torch.Tensor       # [G] visible perspective keypoint u (image px)
    kpt_type: torch.Tensor    # [G] int corner index 0..3
    kpt_visible: torch.Tensor  # [G] bool — kpt inside the left box
    border_u: torch.Tensor    # [G, 2] visible-boundary u (left, right)
    valid: torch.Tensor       # [G] bool — padded/ignore slots are False
    location: torch.Tensor    # [G, 3] 3D bottom-center (x, y, z), metres
    ry: torch.Tensor          # [G] yaw around camera Y
    ignore: torch.Tensor      # [G] bool — slot is an ignore REGION


def zeros_ground_truth(g: int) -> GroundTruth:
    """All-padding GroundTruth of capacity ``g`` (numpy leaves)."""
    return GroundTruth(
        left=np.zeros((g, 4), np.float32),
        right=np.zeros((g, 4), np.float32),
        cls=np.zeros((g,), np.int32),
        dims=np.zeros((g, 3), np.float32),
        alpha=np.zeros((g,), np.float32),
        kpt_u=np.zeros((g,), np.float32),
        kpt_type=np.zeros((g,), np.int32),
        kpt_visible=np.zeros((g,), bool),
        border_u=np.zeros((g, 2), np.float32),
        valid=np.zeros((g,), bool),
        location=np.zeros((g, 3), np.float32),
        ry=np.zeros((g,), np.float32),
        ignore=np.zeros((g,), bool),
    )


def ground_truth_to_torch(gt: GroundTruth,
                          device: torch.device | str) -> GroundTruth:
    """numpy or tensor leaves -> tensors on ``device`` (dtypes kept)."""
    return GroundTruth(*[torch.as_tensor(x, device=device) for x in gt])


class Uniforms(NamedTuple):
    """The uniform [0, 1) draws of one batch's target sampling.

    ``anchor_bg`` serves both background draws of :func:`anchor_targets`:
    the JAX package draws ``uniform(rng_bg, (A,))`` twice with one key."""

    anchor_fg: torch.Tensor   # [B, A]
    anchor_bg: torch.Tensor   # [B, A]
    roi_fg: torch.Tensor      # [B, N + G]
    roi_bg: torch.Tensor      # [B, N + G]
    roi_take: torch.Tensor    # [B, N + G] gather-order jitter


def draw_uniforms(generator: torch.Generator, b: int, a: int, n: int,
                  device: torch.device) -> Uniforms:
    """Fresh draws for ``b`` images, ``a`` anchors and ``n`` candidate rois
    (proposals + GT slots); ``generator`` lives on ``device``."""
    def u(k):
        return torch.rand((b, k), generator=generator, device=device)
    return Uniforms(u(a), u(a), u(n), u(n), u(n))


class AnchorTargets(NamedTuple):
    labels: torch.Tensor       # [B, A] int: 1 fg, 0 bg, -1 ignore
    weights: torch.Tensor      # [B, A] float: 1 for the sampled anchors
    box_targets: torch.Tensor  # [B, A, 6] stereo deltas (defined where fg)
    num_fg: torch.Tensor       # [B]
    num_sampled: torch.Tensor  # [B]


def _sample_topk(eligible: torch.Tensor, k: int,
                 uniform: torch.Tensor) -> torch.Tensor:
    """Mask selecting up to k eligible entries per row at random (fewer
    than k eligible -> all of them: the k-th priority is then ``-inf``)."""
    priority = torch.where(eligible, uniform,
                           torch.full_like(uniform, -torch.inf))
    kth = top_k_stable(priority, k)[0][..., -1:]
    return eligible & (priority >= kth)


def _rank_desc(priority: torch.Tensor) -> torch.Tensor:
    """Position of each entry in ``jnp.argsort(-priority)`` (stable)."""
    order = torch.sort(-priority, dim=-1, stable=True)[1]
    ar = torch.arange(priority.shape[-1], device=priority.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            ar.expand_as(order))


def _ignore_fraction(boxes: torch.Tensor, gt: GroundTruth) -> torch.Tensor:
    """[B, N] max intersection-over-box-area of each box vs the ignore
    regions; ``boxes`` [B or 1, N, 4]."""
    lt = torch.maximum(boxes[..., :, None, :2], gt.left[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], gt.left[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]                         # [B, N, G]
    area = torch.clamp((boxes[..., 2] - boxes[..., 0]) *
                       (boxes[..., 3] - boxes[..., 1]), min=1e-9)[..., None]
    frac = torch.where(gt.ignore[..., None, :], inter / area,
                       torch.zeros_like(inter))
    return frac.max(dim=-1).values


def anchor_targets(anchors: torch.Tensor, gt: GroundTruth, cfg: RPNConfig,
                   im_h: float, im_w: float, u_fg: torch.Tensor,
                   u_bg: torch.Tensor, off: float = 0.0) -> AnchorTargets:
    """RPN targets; anchors [A, 4], GT leaves [B, G, ...], uniforms
    [B, A] (``u_bg`` serves both background draws)."""
    ab = cfg.allowed_border
    inside = ((anchors[:, 0] >= -ab) & (anchors[:, 1] >= -ab) &
              (anchors[:, 2] <= im_w + ab) & (anchors[:, 3] <= im_h + ab))

    gt_union = union_box(gt.left, gt.right)
    iou = pairwise_iou(anchors[None], gt_union, off)           # [B, A, G]
    iou = torch.where(gt.valid[:, None, :] & inside[None, :, None], iou,
                      torch.zeros_like(iou))
    max_iou = iou.max(dim=-1).values
    argmax_gt = iou.argmax(dim=-1)

    labels = torch.full_like(max_iou, -1, dtype=torch.int32)
    labels = torch.where(max_iou < cfg.negative_overlap, 0, labels)
    in_ignore = _ignore_fraction(anchors[None], gt) > cfg.ignore_overlap
    labels = torch.where((labels == 0) & in_ignore, -1, labels)
    labels = torch.where(max_iou >= cfg.positive_overlap, 1, labels)
    # Each valid gt's best inside anchor is positive, unless it overlaps
    # no inside anchor at all.
    best_ok = gt.valid & (iou.max(dim=1).values > 0.0)         # [B, G]
    is_best = torch.zeros_like(labels).scatter_add_(
        1, iou.argmax(dim=1), best_ok.int()) > 0
    labels = torch.where(is_best, 1, labels)
    labels = torch.where(inside[None], labels, -1)

    n_fg_max = int(cfg.batch_size * cfg.fg_fraction)
    fg_sel = _sample_topk(labels == 1, n_fg_max, u_fg)
    n_fg = fg_sel.sum(dim=-1)
    bg_sel = _sample_topk(labels == 0, cfg.batch_size, u_bg)
    # Keep only (batch_size - n_fg) backgrounds, by the same priorities.
    bg_priority = torch.where(bg_sel, u_bg,
                              torch.full_like(u_bg, -torch.inf))
    bg_sel = bg_sel & (_rank_desc(bg_priority) <
                       (cfg.batch_size - n_fg)[:, None])

    weights = (fg_sel | bg_sel).float()
    box_targets = encode_stereo_boxes(
        anchors[None], take_per_image(gt.left, argmax_gt),
        take_per_image(gt.right, argmax_gt), off)
    return AnchorTargets(labels=labels, weights=weights,
                         box_targets=box_targets, num_fg=n_fg,
                         num_sampled=weights.sum(dim=-1))


class RoiTargets(NamedTuple):
    rois_left: torch.Tensor      # [B, S, 4] sampled proposals (gt-augmented)
    rois_right: torch.Tensor     # [B, S, 4]
    cls: torch.Tensor            # [B, S] int class target (0 = bg)
    weights: torch.Tensor        # [B, S] 1.0 for sampled rois
    box_targets: torch.Tensor    # [B, S, 6]
    dim_targets: torch.Tensor    # [B, S, 3] gt_dims - mean_dims
    orien_targets: torch.Tensor  # [B, S, 2] (sin a, cos a)
    kpt_bin: torch.Tensor        # [B, S] int joint (type, u) bin
    kpt_weight: torch.Tensor     # [B, S] 1.0 where the kpt loss applies
    border_bins: torch.Tensor    # [B, S, 2] int boundary bins
    border_weight: torch.Tensor  # [B, S]
    num_fg: torch.Tensor         # [B]


def proposal_targets(prop_left: torch.Tensor, prop_right: torch.Tensor,
                     prop_valid: torch.Tensor, gt: GroundTruth,
                     cfg: RCNNConfig, u_fg: torch.Tensor, u_bg: torch.Tensor,
                     u_take: torch.Tensor, off: float = 0.0) -> RoiTargets:
    """Sample S = ``cfg.rois_per_image`` rois per image and build all head
    targets.  Proposals [B, N, ...]; the GT pairs are appended, so the
    uniforms are [B, N + G].  Unsampled slots (weight 0) can hold zero-area
    padded GT rows; RoIAlign gives those zero features and gradient."""
    s = cfg.rois_per_image
    grid = cfg.kpt_grid

    cand_left = torch.cat([prop_left, gt.left], dim=1)
    cand_right = torch.cat([prop_right, gt.right], dim=1)
    cand_valid = torch.cat([prop_valid, gt.valid], dim=1)

    iou = pairwise_iou(union_box(cand_left, cand_right),
                       union_box(gt.left, gt.right), off)      # [B, N, G]
    iou = torch.where(gt.valid[:, None, :], iou, torch.zeros_like(iou))
    max_iou = torch.where(cand_valid, iou.max(dim=-1).values,
                          torch.zeros_like(iou[..., 0]))
    argmax_gt = iou.argmax(dim=-1)

    is_fg = max_iou >= cfg.fg_thresh
    in_ignore = _ignore_fraction(cand_left, gt) > cfg.ignore_overlap
    is_bg = ((max_iou < cfg.bg_thresh_hi) & (max_iou >= cfg.bg_thresh_lo) &
             cand_valid & ~in_ignore)

    fg_sel = _sample_topk(is_fg, int(s * cfg.fg_fraction), u_fg)
    n_fg = fg_sel.sum(dim=-1)
    bg_priority = torch.where(is_bg & ~fg_sel, u_bg,
                              torch.full_like(u_bg, -torch.inf))
    bg_sel = (bg_priority > -torch.inf) & (_rank_desc(bg_priority) <
                                           (s - n_fg)[:, None])

    # Gather the sampled rois into fixed [S]: fg first, then bg.
    sel_priority = (torch.where(fg_sel, 2.0, torch.where(bg_sel, 1.0, 0.0))
                    + u_take * 0.5)
    take = top_k_stable(sel_priority, s)[1]                    # [B, S]
    sel_fg = torch.gather(fg_sel, 1, take)
    sel_any = torch.gather(fg_sel | bg_sel, 1, take)

    rois_l = take_per_image(cand_left, take)
    rois_r = take_per_image(cand_right, take)
    g_idx = torch.gather(argmax_gt, 1, take)

    def gt_at(x):
        return take_per_image(x, g_idx)

    cls = torch.where(sel_fg, gt_at(gt.cls), 0).int()
    stds = torch.tensor(cfg.bbox_target_stds, dtype=torch.float32,
                        device=rois_l.device)
    box_targets = encode_stereo_boxes(rois_l, gt_at(gt.left),
                                      gt_at(gt.right), off) / stds
    # Dims are offsets from the per-class mean size; bg rows (cls 0) clamp
    # to class 1's mean and carry no dim loss.
    mean_dims = torch.tensor(cfg.mean_dims_hwl, dtype=torch.float32,
                             device=rois_l.device).reshape(-1, 3)
    dim_targets = gt_at(gt.dims) - mean_dims[
        torch.clamp(cls - 1, 0, mean_dims.shape[0] - 1).long()]
    alpha = gt_at(gt.alpha)
    orien_targets = torch.stack([torch.sin(alpha), torch.cos(alpha)], dim=-1)

    # Keypoint joint (type, u-bin) target within the LEFT roi.
    w = torch.clamp(rois_l[..., 2] - rois_l[..., 0], min=1e-3)
    rel = (gt_at(gt.kpt_u) - rois_l[..., 0]) / w
    in_roi = (rel >= 0.0) & (rel < 1.0)
    ubin = torch.clamp((rel * grid).int(), 0, grid - 1)
    kpt_bin = gt_at(gt.kpt_type) * grid + ubin
    kpt_weight = (sel_fg & in_roi & gt_at(gt.kpt_visible)).float()

    rel_b = (gt_at(gt.border_u) - rois_l[..., 0:1]) / w[..., None]
    border_bins = torch.clamp((rel_b * grid).int(), 0, grid - 1)
    border_in = (rel_b >= 0.0).all(-1) & (rel_b < 1.0).all(-1)
    border_weight = (sel_fg & border_in).float()

    return RoiTargets(
        rois_left=rois_l, rois_right=rois_r, cls=cls,
        weights=sel_any.float(), box_targets=box_targets,
        dim_targets=dim_targets, orien_targets=orien_targets,
        kpt_bin=kpt_bin, kpt_weight=kpt_weight, border_bins=border_bins,
        border_weight=border_weight, num_fg=n_fg)
