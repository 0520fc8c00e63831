"""Stereo R-CNN inference path (torch).

Port of ``stereo_rcnn_tpu.models.detector``: a shared-weight backbone over
the left and right images run as one batch, the stereo RPN, the paired
RoIAlign (``rcnn.roi_align_impl``: the fused stereo kernel of
``ops.stereo_roi_align``, a CUDA kernel on the card, or the atlas gather
of ``ops.roi_align``), the RCNN head, per-class decode + NMS + top-k, and
the keypoint head on the NMS survivors only.  Every stage has a fixed
output shape.  ``roi_features`` is differentiable (the fused kernel's
backward is the CUDA kernel ``csrc/stereo_roi_align_bwd.cu`` on the card;
the gather's is autograd's), so training (``train.step``) composes the
same functions.

:class:`StereoRCNN` holds the weights (upstream ``state_dict`` names); the
functions below compose it as the JAX package's functions compose its
parameter tree.  Public tensors are NHWC.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from stereo_rcnn_tpu_torch.config import Config
from stereo_rcnn_tpu_torch.device import resolve_device
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.geometry.boxes import (clip_boxes,
                                                  decode_stereo_boxes,
                                                  union_box)
from stereo_rcnn_tpu_torch.models.heads import (ConvTranspose2d, KeypointHead,
                                                RCNNHead, RCNNOutputs)
from stereo_rcnn_tpu_torch.models.resnet_fpn import Conv2d, ResNetFPN
from stereo_rcnn_tpu_torch.models.stereo_rpn import (Proposals, StereoRPNHead,
                                                     select_proposals,
                                                     take_per_image)
from stereo_rcnn_tpu_torch.ops.nms import nms_indices, top_k_stable
from stereo_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align
from stereo_rcnn_tpu_torch.ops.stereo_roi_align import stereo_roi_align_packed
from stereo_rcnn_tpu_torch.utils.device_constants import table
from stereo_rcnn_tpu_torch.utils.profiling import span


class StereoRCNN(nn.Module):
    """Backbone, RPN head, RCNN head and keypoint head of one config.

    ``state_dict`` keys are the upstream names under the containers
    ``backbone_net.``, ``rcnn_head.`` and ``kpt_head.`` (the RPN's
    ``RCNN_rpn.`` is upstream's own)."""

    def __init__(self, cfg: Config):
        super().__init__()
        rc = cfg.rcnn
        if (rc.roi_align_impl == "pallas" and
                rc.kpt_pool_size != 2 * rc.pooling_size):
            raise ValueError("the fused RoIAlign needs kpt_pool_size == "
                             "2 * pooling_size")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        d = cfg.backbone.fpn_dim
        bb = cfg.backbone
        self.backbone_net = ResNetFPN(bb.depth, d, bb.norm, bb.frozen_stages,
                                      bb.remat, bb.fpn_upsample)
        self.RCNN_rpn = StereoRPNHead(d, cfg.anchors.num_anchors_per_cell,
                                      cfg.rpn.conv_dim)
        self.rcnn_head = RCNNHead(d, rc.pooling_size, rc.num_classes,
                                  rc.fc_dim)
        self.kpt_head = KeypointHead(d)

    def backbone(self, images: torch.Tensor):
        return self.backbone_net(images, self.compute_dtype)

    def rpn(self, feats_left, feats_right):
        return self.RCNN_rpn(feats_left, feats_right)

    def heads(self, pooled_concat: torch.Tensor) -> RCNNOutputs:
        return self.rcnn_head(pooled_concat, self.compute_dtype)

    def keypoints(self, pooled_left: torch.Tensor) -> torch.Tensor:
        return self.kpt_head(pooled_left, self.compute_dtype)


# ---------------------------------------------------------------------------
# Functional composition.
# ---------------------------------------------------------------------------

def forward_raw(model: StereoRCNN, images_left: torch.Tensor,
                images_right: torch.Tensor, train: bool = False) -> dict:
    """Backbone + RPN + proposals + paired RoIAlign + heads, batched."""
    cfg = model.cfg
    b, im_h, im_w, _ = images_left.shape

    with span("infer/backbone"):
        feats = model.backbone(torch.cat([images_left, images_right], dim=0))
        feats_l = [f[:b] for f in feats]
        feats_r = [f[b:] for f in feats]

    with span("infer/rpn"):
        logits, deltas = model.rpn(feats_l, feats_r)         # [B, A, 2|6]
        anchors = generate_anchors(cfg.anchors, im_h, im_w, off=cfg.box_off,
                                   device=images_left.device)
        props = select_proposals(logits, deltas, anchors, im_h, im_w,
                                 cfg.rpn, train, off=cfg.box_off)

    with span("infer/roi_align"):
        pooled = roi_features(model, feats_l, feats_r, props.left,
                              props.right)
    with span("infer/heads"):
        outputs = model.heads(pooled["concat"])
        n = props.left.shape[1]
        rows = pooled["left_kpt_rows"].shape[1]
        return {
            "rpn_logits": logits,
            "rpn_deltas": deltas,
            "anchors": anchors,
            "proposals": props,
            "rcnn": RCNNOutputs(*[x.reshape(b, n, *x.shape[1:])
                                  for x in outputs]),
            "kpt_feats": pooled["left_kpt_rows"].reshape(
                b, n, rows, pooled["left_kpt_rows"].shape[-1]),
        }


def roi_features(model: StereoRCNN, feats_l, feats_r, rois_left,
                 rois_right) -> dict:
    """Paired RoIAlign producing the head inputs (rois [B, N, 4]).

    Returns ``concat`` [B*N, P, P, 2C] (left || right, for the FC trunk),
    ``left_kpt`` [B*N, Pk, Pk, C] and ``left_kpt_rows`` [B*N, rows, C],
    whose first Pk*Pk rows are the kpt samples.

    ``rcnn.roi_align_impl="pallas"``: the fused stereo kernel (K1 on the
    card) with ``rcnn.roi_align_hat`` sampling weights, float32; the rows
    are its 294 packed rows, and slices are views (the keypoint branch
    gathers its survivors before slicing, so the block is not copied).
    Any other value: three :func:`multilevel_roi_align` calls, as in the
    JAX package (left and right 7x7 at ``sampling_ratio``, left 14x14 at
    ratio 1), in the features' dtype; the rows are the 196 kpt samples.
    """
    cfg = model.cfg
    strides = cfg.anchors.strides[:4]                 # rois use P2..P5 only
    p, pk = cfg.rcnn.pooling_size, cfg.rcnn.kpt_pool_size
    b, n = rois_left.shape[:2]
    if cfg.rcnn.roi_align_impl != "pallas":
        sr = cfg.rcnn.sampling_ratio
        pl_ = multilevel_roi_align(feats_l[:4], rois_left, strides, p, sr)
        pr_ = multilevel_roi_align(feats_r[:4], rois_right, strides, p, sr)
        # The 14x14 output already oversamples the bins: ratio 1 gives the
        # 7x7 / ratio-2 pools' sample positions.
        pk_l = multilevel_roi_align(feats_l[:4], rois_left, strides, pk, 1)
        c = pl_.shape[-1]
        return {
            "concat": torch.cat([pl_, pr_], dim=-1).reshape(b * n, p, p,
                                                           2 * c),
            "left_kpt": pk_l.reshape(b * n, pk, pk, c),
            "left_kpt_rows": pk_l.reshape(b * n, pk * pk, c),
        }
    packed = stereo_roi_align_packed(feats_l[:4], feats_r[:4], rois_left,
                                     rois_right, strides,
                                     cfg.rcnn.roi_align_hat)  # [B, N, rows, C]
    c = packed.shape[-1]
    kk, pp = pk * pk, p * p
    flat = packed.reshape(b * n, kk + 2 * pp, c)
    pl_ = flat[:, kk:kk + pp].reshape(b * n, p, p, c)
    pr_ = flat[:, kk + pp:].reshape(b * n, p, p, c)
    return {
        "concat": torch.cat([pl_, pr_], dim=-1),
        "left_kpt": flat[:, :kk].reshape(b * n, pk, pk, c),
        "left_kpt_rows": flat,
    }


class Detections(NamedTuple):
    """Padded per-image detections (all [B, D, ...])."""

    box_left: torch.Tensor     # [B, D, 4]
    box_right: torch.Tensor    # [B, D, 4]
    score: torch.Tensor        # [B, D]
    cls: torch.Tensor          # [B, D] int
    dims: torch.Tensor         # [B, D, 3] (h, w, l) metres
    alpha: torch.Tensor        # [B, D] viewpoint angle
    kpt_u: torch.Tensor        # [B, D] perspective keypoint u (image px)
    kpt_type: torch.Tensor     # [B, D] int corner index 0..3
    kpt_prob: torch.Tensor     # [B, D] confidence of the keypoint peak
    border_u: torch.Tensor     # [B, D, 2] visible-boundary u (image px)
    valid: torch.Tensor        # [B, D] bool


def postprocess_boxes(raw: dict, cfg: Config, im_h: int, im_w: int):
    """Per-class decode + threshold + NMS, merged by a top-k on score.

    Returns ``(det, idx, rois)``: detections with placeholder keypoint
    fields, the [B, D] surviving proposal indices and their [B, D, 4]
    proposal boxes.
    """
    rc = cfg.rcnn
    props: Proposals = raw["proposals"]
    rcnn: RCNNOutputs = raw["rcnn"]
    dev = props.left.device
    mean_dims = table("mean_dims", rc.mean_dims_hwl, dev).reshape(-1, 3)
    if mean_dims.shape[0] not in (1, rc.num_classes - 1):
        raise ValueError(
            f"mean_dims_hwl must be [3] or [(num_classes-1), 3]; got "
            f"{tuple(mean_dims.shape)} for num_classes={rc.num_classes}")
    probs = torch.softmax(rcnn.cls_logits, dim=-1)            # [B, N, K]
    off = cfg.box_off
    stds = table("stds", rc.bbox_target_stds, dev)
    b = probs.shape[0]

    per_class = []
    for c in range(1, rc.num_classes):
        score = torch.where(props.valid, probs[..., c],
                            torch.zeros_like(probs[..., c]))
        deltas = rcnn.box_deltas[:, :, c, :] * stds
        box_l, box_r = decode_stereo_boxes(props.left, deltas, off)
        box_l = clip_boxes(box_l, im_h, im_w, off)
        box_r = clip_boxes(box_r, im_h, im_w, off)
        keep = score >= rc.score_thresh
        idx, valid = nms_indices(union_box(box_l, box_r), score,
                                 rc.final_nms_thresh, rc.max_detections,
                                 valid=keep, off=off)
        dims = (mean_dims[min(c - 1, mean_dims.shape[0] - 1)] +
                take_per_image(rcnn.dims[:, :, c, :], idx))
        orien = take_per_image(rcnn.orien[:, :, c, :], idx)
        score = take_per_image(score, idx)
        d = idx.shape[1]
        zeros = torch.zeros((b, d), dtype=torch.float32, device=dev)
        det = Detections(
            box_left=take_per_image(box_l, idx),
            box_right=take_per_image(box_r, idx), score=score,
            cls=torch.full((b, d), c, dtype=torch.int32, device=dev),
            dims=dims, alpha=torch.atan2(orien[..., 0], orien[..., 1]),
            kpt_u=zeros, kpt_type=torch.zeros((b, d), dtype=torch.int32,
                                              device=dev),
            kpt_prob=zeros,
            border_u=torch.zeros((b, d, 2), dtype=torch.float32, device=dev),
            valid=valid & (score > 0))
        per_class.append((det, idx, take_per_image(props.left, idx)))

    # Merge the classes' survivors by score (an identity re-sort for K=2).
    flat = Detections(*[torch.cat(x, dim=1)
                        for x in zip(*[d for d, _, _ in per_class])])
    idxs = torch.cat([i for _, i, _ in per_class], dim=1)
    rois = torch.cat([r for _, _, r in per_class], dim=1)
    order = top_k_stable(torch.where(flat.valid, flat.score,
                                     torch.full_like(flat.score, -1.0)),
                         rc.max_detections)[1]
    det = Detections(*[take_per_image(x, order) for x in flat])
    return det, take_per_image(idxs, order), take_per_image(rois, order)


def decode_keypoints(kpt_logits: torch.Tensor, rois: torch.Tensor,
                     kpt_softmax: str = "joint"):
    """Keypoint decode over the proposal boxes the branch pooled.

    kpt_logits [..., 6, G], rois [..., 4] -> (kpt_u, kpt_type, peak,
    border_u).  "joint": one softmax over the 4 x G corner bins;
    "per_channel": a G-bin softmax per corner channel.
    """
    kl = kpt_logits
    g = kl.shape[-1]
    lead = kl.shape[:-2]
    if kpt_softmax == "joint":
        persp_prob = torch.softmax(kl[..., :4, :].reshape(*lead, 4 * g),
                                   dim=-1)
    elif kpt_softmax == "per_channel":
        persp_prob = torch.softmax(kl[..., :4, :], dim=-1).reshape(
            *lead, 4 * g)
    else:
        raise ValueError(f"rcnn.kpt_softmax: unknown mode {kpt_softmax!r} "
                         "(expected 'joint' or 'per_channel')")
    flat_idx = torch.argmax(persp_prob, dim=-1)
    kpt_type = (flat_idx // g).int()
    kpt_bin = (flat_idx % g).float()
    peak = torch.gather(persp_prob, -1, flat_idx[..., None])[..., 0]
    w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-3)
    kpt_u = rois[..., 0] + (kpt_bin + 0.5) / g * w
    border_bin = torch.argmax(kl[..., 4:6, :], dim=-1).float()
    border_u = rois[..., 0:1] + (border_bin + 0.5) / g * w[..., None]
    return kpt_u, kpt_type, peak, border_u


def run_keypoints(model: StereoRCNN, raw: dict, det: Detections,
                  idx: torch.Tensor, rois: torch.Tensor) -> Detections:
    """Keypoint convs on the NMS survivors only: gather their packed rows,
    slice the kpt samples, and fill the keypoint fields of ``det``."""
    kf = take_per_image(raw["kpt_feats"], idx)             # [B, D, rows, C]
    b, d = kf.shape[:2]
    pk = model.cfg.rcnn.kpt_pool_size
    kf = kf[:, :, :pk * pk].reshape(b * d, pk, pk, kf.shape[-1])
    kl = model.keypoints(kf)
    kl = kl.reshape(b, d, *kl.shape[1:])                     # [B, D, 6, G]
    kpt_u, kpt_type, peak, border_u = decode_keypoints(
        kl, rois, model.cfg.rcnn.kpt_softmax)
    return det._replace(kpt_u=kpt_u, kpt_type=kpt_type, kpt_prob=peak,
                        border_u=border_u)


def build_model(cfg: Config) -> StereoRCNN:
    return StereoRCNN(cfg)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal on [-2, 2] std units,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(std)


def init_params(cfg: Config, generator: torch.Generator,
                device: torch.device | str | None = None) -> StereoRCNN:
    """A randomly initialised model with flax's variances: lecun-normal
    kernels, zero biases, normal(0.01) for the RPN and ``cls_score``,
    normal(0.001) for ``bbox_pred``, ``dim_orien_pred`` and ``kpt_score``;
    norms as flax initialises them (frozen BN identity, affine scale 1 and
    0 on ``bn3``, GroupNorm scale 1 and bias 0: the modules' own init).
    Draws on the CPU from ``generator``, then moves the model to
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    model = build_model(cfg)
    small = {model.RCNN_rpn.RPN_Conv: 0.01,
             model.RCNN_rpn.RPN_cls_score: 0.01,
             model.RCNN_rpn.RPN_bbox_pred: 0.01,
             model.rcnn_head.RCNN_cls_score: 0.01,
             model.rcnn_head.RCNN_bbox_pred: 0.001,
             model.rcnn_head.RCNN_dim_orien_pred: 0.001,
             model.kpt_head.RCNN_kpts_score: 0.001}
    for mod in model.modules():
        if not isinstance(mod, (Conv2d, ConvTranspose2d, nn.Linear)):
            continue
        w = mod.weight
        with torch.no_grad():
            if mod in small:
                w.normal_(0.0, small[mod], generator=generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(w, w.shape[1], generator)
            elif isinstance(mod, ConvTranspose2d):
                # flax ConvTranspose(transpose_kernel=True): fan_in counts
                # the output features.
                _lecun_normal_(w, int(np.prod(w.shape[2:])) * w.shape[1],
                               generator)
            else:
                _lecun_normal_(w, int(np.prod(w.shape[1:])), generator)
            if mod.bias is not None:
                mod.bias.zero_()
    return model.to(device).eval()


def make_inference_fn(cfg: Config, im_h: int | None = None,
                      im_w: int | None = None):
    """``fn(model, images_left, images_right) -> Detections``: the
    end-to-end 2D inference path."""
    h = im_h or cfg.data.image_h
    w = im_w or cfg.data.image_w

    @torch.no_grad()
    def fn(model: StereoRCNN, images_left, images_right) -> Detections:
        raw = forward_raw(model, images_left, images_right, train=False)
        with span("infer/post"):
            det, idx, rois = postprocess_boxes(raw, cfg, h, w)
        with span("infer/keypoints"):
            return run_keypoints(model, raw, det, idx, rois)

    return fn
