"""The measured program's training step as plain PyTorch in float32: a
frozen copy of its loss forward, its target sampling and its optimizer,
run with TF32 off (:mod:`..precision`), no remat and no kernel.

One step takes the weights, the momentum traces, the step count, a batch
(images and packed ground truth), the target-sampling uniforms and,
where it follows the program, the program's proposals of that step; it
returns the six losses, the per-image foreground counts, every
trainable leaf's gradient, and the updated weights and traces, all new
tensors (the inputs are not changed).

The batch runs in blocks of ``block`` images and the gradients add up
over the blocks.  That is the whole batch's gradient: GroupNorm
normalises each image alone, every loss is a mean over the images, and
the program's total ``sum_i loss_i * exp(-s_i) + s_i`` (learned
uncertainty weights, upstream's ``trainval_net.py``) splits into each
block's share of the first term and the ``+ s`` term once, after the
last block.  The clip and the update follow the last block.

The fused stereo RoIAlign is the reference's plain version with exact
sampling weights (``ops/stereo_roi_align.py``); its gradient is
autograd's through the gathers, where the program runs its CUDA kernels
K1 and K2.

Where this departs from upstream Stereo R-CNN (``trainval_net.py``,
``cfgs/res101.yml``), it keeps the program's recipe
(``configs/synthetic_fullres.yml``):

* GroupNorm-32 at every norm site, trained from scratch, where upstream
  fine-tunes ImageNet-pretrained BN frozen into a scale and a bias (and
  freezes the stem and ``layer1``);
* weights random from the seed (``reference/train/weights.py``, the
  output layers at upstream's ``normal_init``), not ImageNet's;
* fixed shapes: proposals are selected by leader-election NMS to a fixed
  count, targets are sampled by random-priority top-k with the uniforms
  handed in, and the ground truth is padded to ``max_gt_boxes``;
* RoIs are pooled by the fused stereo RoIAlign, whose samples are clamped
  to a window per level (upstream pools each side on its own);
* the optimizer is optax's chain: clip by the global norm with no
  epsilon, decay on kernels only, SGD with momentum ``m = g + 0.9 m`` and
  ``p -= lr * m`` (upstream: torch's SGD, decay on every weight, and
  ``clip_gradient`` per step).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from h100_bench.reference import precision
from h100_bench.reference.config import Config
from h100_bench.reference.geometry.anchors import generate_anchors
from h100_bench.reference.models.detector import build_model, roi_features
from h100_bench.reference.models.stereo_rpn import select_proposals
from h100_bench.reference.train.losses import (LOSS_NAMES, rcnn_losses,
                                               rpn_losses)
from h100_bench.reference.train.targets import (GroundTruth, Uniforms,
                                                anchor_targets,
                                                proposal_targets)

#: Faults a step can be made to carry, for the calibration of the
#: correctness check (``compare/train.py``): the right side's RoIAlign
#: gradient zeroed (K2's right half), the keypoint loss left out, the clip
#: skipped, the momentum reset each step.
STEP_FAULTS = ("fault_k2_right_zero", "fault_kpt_loss_out",
               "fault_clip_skipped", "fault_momentum_reset")


class Batch(NamedTuple):
    left: torch.Tensor          # [B, H, W, 3] mean-subtracted BGR
    right: torch.Tensor
    gt: GroundTruth             # leaves [B, G, ...] on the device


class StepResult(NamedTuple):
    losses: Dict[str, torch.Tensor]     # LOSS_NAMES -> 0-dim batch means
    num_fg_rpn: torch.Tensor            # [B]
    num_fg_rcnn: torch.Tensor           # [B]
    proposals: Dict[str, torch.Tensor]  # left, right [B, N, 4], valid [B, N]
    grads: Dict[str, torch.Tensor]      # every trainable leaf and "uncert"
    g_norm: torch.Tensor
    params: Dict[str, torch.Tensor]     # after the update
    trace: Dict[str, torch.Tensor]


def train_config(cfg: Config) -> Config:
    """The reference's own configuration of ``cfg``: float32, no remat,
    exact RoIAlign weights."""
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, remat=False),
        rcnn=dataclasses.replace(cfg.rcnn, roi_align_hat="f32"))


def param_label(name: str, freeze_stem: bool = True,
                train_bn: bool = False) -> str:
    """Optimizer partition of one parameter (``state_dict`` name, or
    ``"uncert"``): "frozen", "decay" (kernels), "plain" (biases,
    GroupNorm affines) or "uncert"."""
    segs = name.split(".")
    if segs[0] == "uncert":
        return "uncert"
    if "gn" in segs:
        return "plain"
    module = ".".join(segs[:-1])
    if segs[-2].startswith("bn") or module.endswith(("downsample.1",
                                                     "RCNN_layer0.1")):
        return "plain" if train_bn else "frozen"
    if (freeze_stem and segs[0] == "backbone_net"
            and segs[1] in ("RCNN_layer0", "RCNN_layer1")):
        return "frozen"
    return "decay" if segs[-1] == "weight" else "plain"


def labels_of(cfg: Config) -> dict:
    return {"freeze_stem": cfg.backbone.norm == "frozen",
            "train_bn": cfg.backbone.norm == "affine"}


def learning_rate(cfg: Config, steps_per_epoch: int, count: int) -> float:
    """The step schedule in float32: ``lr`` until ``lr_decay_step``
    epochs, then ``lr * gamma``."""
    t = cfg.train
    lr = torch.tensor(t.learning_rate, dtype=torch.float32)
    if count >= t.lr_decay_step * steps_per_epoch:
        lr = lr * torch.tensor(t.lr_decay_gamma, dtype=torch.float32)
    return float(lr)


def sgd_update(cfg: Config, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               trace: Dict[str, torch.Tensor], count: int,
               steps_per_epoch: int, clip: bool = True):
    """``(params, trace, g_norm)`` after one optimizer step, as new
    tensors: the gradients clipped by their global norm (frozen leaves
    count as zeros) unless ``clip`` is False, decay added on the "decay"
    leaves, then SGD with momentum."""
    t = cfg.train
    labels = labels_of(cfg)
    g_norm = torch.stack([g.float().square().sum()
                          for g in grads.values()]).sum().sqrt()
    scale = clip and bool(g_norm >= t.grad_clip)
    lr = learning_rate(cfg, steps_per_epoch, count)
    new_params, new_trace = {}, {}
    for name, p in params.items():
        label = param_label(name, **labels)
        if label == "frozen":
            new_params[name] = p
            continue
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        if scale:
            g = g / g_norm * t.grad_clip
        if label == "decay":
            g = g + t.weight_decay * p
        m = trace.get(name)
        m = g if m is None else g + t.momentum * m
        new_trace[name] = m
        new_params[name] = p + m * -lr
    return new_params, new_trace, g_norm


def image_losses(model, cfg: Config, batch: Batch, uniforms: Uniforms,
                 proposals: Optional[Dict[str, torch.Tensor]] = None,
                 fault: Optional[str] = None):
    """``(losses, at, rt, proposals)``: the six losses per image ``[b]``
    of a block, its anchor and proposal targets, and the proposals that
    fed them (``proposals`` where given, else the reference's own)."""
    b, im_h, im_w, _ = batch.left.shape
    gt = batch.gt
    feats = model.backbone(torch.cat([batch.left, batch.right], dim=0))
    feats_l = [f[:b] for f in feats]
    feats_r = [f[b:] for f in feats]
    anchors = generate_anchors(cfg.anchors, im_h, im_w, cfg.box_off,
                               batch.left.device)
    at = anchor_targets(anchors, gt, cfg.rpn, im_h, im_w,
                        uniforms.anchor_fg, uniforms.anchor_bg, cfg.box_off)
    logits, deltas = model.rpn(feats_l, feats_r)
    losses = rpn_losses(logits, deltas, at)
    if proposals is None:
        props = select_proposals(logits.detach(), deltas.detach(), anchors,
                                 im_h, im_w, cfg.rpn, True, cfg.box_off)
        proposals = {"left": props.left, "right": props.right,
                     "valid": props.valid}
    rt = proposal_targets(proposals["left"], proposals["right"],
                          proposals["valid"], gt, cfg.rcnn, uniforms.roi_fg,
                          uniforms.roi_bg, uniforms.roi_take, cfg.box_off)
    if fault == "fault_k2_right_zero":
        feats_r = [f.detach() for f in feats_r]
    pooled = roi_features(model, feats_l, feats_r, rt.rois_left,
                          rt.rois_right)
    outs = model.heads(pooled["concat"])
    kpt_logits = model.keypoints(pooled["left_kpt"])
    s = cfg.rcnn.rois_per_image
    outs = type(outs)(*[x.reshape(b, s, *x.shape[1:]) for x in outs])
    kpt_logits = kpt_logits.reshape(b, s, *kpt_logits.shape[1:])
    losses.update(rcnn_losses(outs, kpt_logits, rt, cfg.rcnn.kpt_softmax))
    if fault == "fault_kpt_loss_out":
        losses["kpt"] = torch.zeros_like(losses["kpt"])
    return losses, at, rt, proposals


def reference_step(cfg: Config, params: Dict[str, torch.Tensor],
                   trace: Dict[str, torch.Tensor], count: int,
                   batch: Batch, uniforms: Uniforms, steps_per_epoch: int,
                   proposals: Optional[Dict[str, torch.Tensor]] = None,
                   block: int = 1, lowered: bool = False,
                   fault: Optional[str] = None,
                   flops: Optional[list] = None) -> StepResult:
    """One training step of ``cfg`` (the program's configuration; the
    reference runs :func:`train_config` of it) from ``params`` (the
    model's ``state_dict`` and ``"uncert"``), ``trace`` and ``count``,
    in blocks of ``block`` images.  ``proposals``: the program's (follow
    it), or None (the reference selects its own, as the program would).
    ``lowered``: the control's precision (``precision.lowered``).
    ``fault``: one of :data:`STEP_FAULTS`.  ``flops``: a list to which
    the FLOPs of the first block's forward and backward are appended
    (``work.flops``)."""
    rcfg = train_config(cfg)
    with torch.device("meta"):
        model = build_model(rcfg)
    weights = {k: v for k, v in params.items() if k != "uncert"}
    model.load_state_dict(weights, strict=True, assign=True)
    model.train()
    uncert = params["uncert"].detach().clone().requires_grad_(True)
    b = batch.left.shape[0]
    sums = dict.fromkeys(LOSS_NAMES, 0.0)
    fg_rpn, fg_rcnn, props = [], [], []

    def one_block(i):
        sl = slice(i, i + block)
        part = Batch(batch.left[sl], batch.right[sl],
                     GroundTruth(*[x[sl] for x in batch.gt]))
        mine = None if proposals is None else {
            k: v[sl] for k, v in proposals.items()}
        losses, at, rt, used = image_losses(
            model, rcfg, part, Uniforms(*[u[sl] for u in uniforms]), mine,
            fault)
        stacked = torch.stack([losses[k].sum() for k in LOSS_NAMES])
        (stacked * torch.exp(-uncert)).sum().div(b).backward()
        return stacked.detach(), at.num_fg, rt.num_fg, used

    mode = precision.lowered() if lowered else contextlib.nullcontext()
    with precision.float32(), mode:
        for i in range(0, b, block):
            if flops is not None and i == 0:
                from h100_bench.work.flops import count_flops
                n, out = count_flops(one_block, i)
                flops.append(n)
            else:
                out = one_block(i)
            stacked, n_rpn, n_rcnn, used = out
            for k, v in zip(LOSS_NAMES, stacked):
                sums[k] = sums[k] + v
            fg_rpn.append(n_rpn)
            fg_rcnn.append(n_rcnn)
            props.append(used)
        uncert.sum().backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()
                 if param_label(n, **labels_of(rcfg)) != "frozen"}
        grads["uncert"] = uncert.grad
        momentum = {} if fault == "fault_momentum_reset" else trace
        new_params, new_trace, g_norm = sgd_update(
            rcfg, {**weights, "uncert": params["uncert"]}, grads, momentum,
            count, steps_per_epoch, clip=fault != "fault_clip_skipped")
    return StepResult(
        losses={k: v / b for k, v in sums.items()},
        num_fg_rpn=torch.cat(fg_rpn), num_fg_rcnn=torch.cat(fg_rcnn),
        proposals={k: torch.cat([p[k] for p in props]) for k in props[0]},
        grads={k: v.detach() for k, v in grads.items()}, g_norm=g_norm,
        params=new_params, trace=new_trace)
