"""Training: loss forward, optimizer and the train step (torch).

Port of ``stereo_rcnn_tpu.train.step``.  One step runs backbone -> RPN ->
anchor targets -> proposals (no gradient through the boxes) -> proposal
targets -> fused stereo RoIAlign (K1 forward, K2 backward on the card) ->
RCNN and keypoint heads on the sampled rois -> six losses combined with
learned uncertainty weights, then the optimizer.

The optimizer is optax's chain written out, to its conventions:
``clip_by_global_norm`` over every gradient (frozen ones count as zeros),
scaling by ``max_norm / g_norm`` only when ``g_norm >= max_norm`` and with
no epsilon; then per :func:`param_label` partition: "frozen" unchanged,
"decay" ``g + wd * p`` then SGD, "plain" and "uncert" SGD.  SGD is
``optax.sgd(schedule, momentum)``: ``m = g + momentum * m``,
``p -= lr(count) * m``, and the step schedule decays the rate by gamma once
``count >= lr_decay_step * steps_per_epoch``.  Parameters and momentum are
updated in place.  The step's three parts are spans of
``utils.profiling`` (``train/losses``, ``train/backward``,
``train/optimizer``); a data-parallel step
(``parallel.data_parallel_train_step``) adds ``train/all_reduce`` between
the last two (inside it ``train/all_reduce/flatten``, ``.../collective``
and ``.../unflatten``) and ``train/mean_metrics`` after them.  Inside
``train/losses``: ``train/backbone``,
``train/targets`` (anchors and their targets), ``train/rpn`` (the head and
its losses), ``train/targets`` again (proposals and their targets),
``train/roi_align`` and ``train/heads`` (the RCNN and keypoint heads and
their losses).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from stereo_rcnn_tpu_torch.config import Config
from stereo_rcnn_tpu_torch.device import resolve_device
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.models.detector import (StereoRCNN, build_model,
                                                   init_params, roi_features)
from stereo_rcnn_tpu_torch.models.stereo_rpn import select_proposals
from stereo_rcnn_tpu_torch.train.losses import (LOSS_NAMES,
                                                combine_with_uncertainty,
                                                rcnn_losses, rpn_losses)
from stereo_rcnn_tpu_torch.train.targets import (GroundTruth, Uniforms,
                                                 anchor_targets,
                                                 draw_uniforms,
                                                 ground_truth_to_torch,
                                                 proposal_targets)
from stereo_rcnn_tpu_torch.utils.profiling import span


class Batch(NamedTuple):
    """One training batch on the device (leading dim B)."""

    images_left: torch.Tensor   # [B, H, W, 3] mean-subtracted BGR
    images_right: torch.Tensor  # [B, H, W, 3]
    gt: GroundTruth             # leaves [B, G, ...]


@dataclasses.dataclass
class TrainState:
    """The model, the uncertainty weights, optax's SGD traces (momentum,
    keyed like :func:`trainable_params`) and the step count."""

    step: int
    model: StereoRCNN
    uncert: torch.Tensor                 # [6] float32, requires grad
    trace: Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameter partitioning: frozen vs decayed vs plain vs uncertainty.
# ---------------------------------------------------------------------------

def param_label(name: str, freeze_stem: bool = True,
                train_bn: bool = False) -> str:
    """Optimizer partition of one port parameter (``state_dict`` name, or
    ``"uncert"``), as the JAX package's ``param_label`` labels the same
    leaf: GroupNorm affines (``...gn.weight``) train without decay; BN
    constants are frozen unless ``train_bn`` (the "affine" norm);
    ``freeze_stem`` freezes the stem conv and layer1 (FIXED_BLOCKS=1);
    weight decay applies to kernels, not biases."""
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


def trainable_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every parameter the optimizer sees, by name: the model's (frozen
    ones included) and ``"uncert"``."""
    return {**dict(state.model.named_parameters()), "uncert": state.uncert}


def make_schedule(cfg: Config, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    """``optax.piecewise_constant_schedule(lr, {decay_step * spe: gamma})``
    in float32 arithmetic."""
    t = cfg.train
    boundary = t.lr_decay_step * steps_per_epoch
    lr = torch.tensor(t.learning_rate, dtype=torch.float32)
    decayed = lr * torch.tensor(t.lr_decay_gamma, dtype=torch.float32)

    def schedule(count: int) -> float:
        return float(lr if count < boundary else decayed)
    return schedule


def make_optimizer(cfg: Config, steps_per_epoch: int):
    """``(update, schedule)``: ``update(params, trace, count) -> g_norm``
    applies one optimizer step to ``params`` (name -> tensor with
    ``.grad``; None counts as zero) and their ``trace`` in place."""
    t = cfg.train
    schedule = make_schedule(cfg, steps_per_epoch)
    labels = {"freeze_stem": cfg.backbone.norm == "frozen",
              "train_bn": cfg.backbone.norm == "affine"}

    @torch.no_grad()
    def update(params: Dict[str, torch.Tensor],
               trace: Dict[str, torch.Tensor], count: int) -> torch.Tensor:
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        dev = params["uncert"].device
        g_norm = torch.stack([g.float().square().sum()
                              for g in grads.values()]
                             or [torch.zeros((), device=dev)]).sum().sqrt()
        clip = g_norm >= t.grad_clip
        lr = schedule(count)
        for name, p in params.items():
            label = param_label(name, **labels)
            if label == "frozen":
                continue
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            g = torch.where(clip, g / g_norm * t.grad_clip, g)
            if label == "decay":
                g = g + t.weight_decay * p
            m = trace.get(name)
            m = g if m is None else g + t.momentum * m
            trace[name] = m
            p.add_(m * -lr)
        return g_norm

    return update, schedule


def init_train_state(cfg: Config, generator: torch.Generator | None = None,
                     state_dict: Dict[str, torch.Tensor] | None = None,
                     device: torch.device | str | None = None) -> TrainState:
    """A fresh state on ``device`` (default: the CUDA card): the model from
    ``state_dict`` (``convert.from_jax`` output; its ``"uncert"`` entry, if
    any, seeds the uncertainty weights) or else :func:`init_params` drawn
    from ``generator``; uncertainty weights zero; no momentum yet."""
    device = resolve_device(device)
    uncert = torch.zeros(len(LOSS_NAMES), dtype=torch.float32)
    if state_dict is None:
        if generator is None:
            raise ValueError("init_train_state needs a generator or a "
                             "state_dict")
        model = init_params(cfg, generator, device)
    else:
        state_dict = dict(state_dict)
        uncert = state_dict.pop("uncert", uncert)
        model = build_model(cfg)
        model.load_state_dict(state_dict, strict=True)
        model = model.to(device)
    uncert = uncert.detach().clone().to(device).requires_grad_(True)
    return TrainState(step=0, model=model.train(), uncert=uncert, trace={})


# ---------------------------------------------------------------------------
# Loss forward.
# ---------------------------------------------------------------------------

def compute_losses(model: StereoRCNN, batch: Batch, cfg: Config,
                   generator: torch.Generator | None = None,
                   uniforms: Uniforms | None = None,
                   rows: Tuple[int, int] | None = None,
                   evidence: Dict[str, torch.Tensor] | None = None
                   ) -> Dict[str, torch.Tensor]:
    """All 6 losses averaged over the batch, and the mean foreground
    counts.  Target sampling draws from ``generator`` unless ``uniforms``
    gives the draws.  ``rows = (start, total)``: the batch is rows
    ``start ..`` of a global batch of ``total`` images, and the draws (the
    generator's or ``uniforms``) are the global batch's, of which it takes
    its rows: a rank of a data-parallel step samples as one process at the
    global batch does (``jax.random.split(rng, 2 * b)`` over the global
    ``b`` in the JAX package).  ``evidence``, if given, gets the proposals
    that fed :func:`proposal_targets` (``left``, ``right`` [B, N, 4] and
    ``valid`` [B, N], detached) and the per-image foreground counts
    (``num_fg_rpn``, ``num_fg_rcnn`` [B]), so that a check can repeat the
    step on the same proposals, and what the sampling chose: the sampled
    anchors (``anchor_weights`` [B, A], 1 where sampled) and RoIs
    (``rois_left`` [B, S, 4], ``roi_weights`` [B, S])."""
    b, im_h, im_w, _ = batch.images_left.shape
    dev = batch.images_left.device
    gt = batch.gt

    with span("train/backbone"):
        feats = model.backbone(torch.cat([batch.images_left,
                                          batch.images_right], dim=0))
        feats_l = [f[:b] for f in feats]
        feats_r = [f[b:] for f in feats]

    with span("train/targets"):
        anchors = generate_anchors(cfg.anchors, im_h, im_w, cfg.box_off,
                                   dev)
        start, total = (0, b) if rows is None else rows
        if uniforms is None:
            uniforms = draw_uniforms(
                generator, total, anchors.shape[0],
                cfg.rpn.train_post_nms_top_n + gt.left.shape[1], dev)
        if total != b:
            uniforms = Uniforms(*[u[start:start + b] for u in uniforms])
        at = anchor_targets(anchors, gt, cfg.rpn, im_h, im_w,
                            uniforms.anchor_fg, uniforms.anchor_bg,
                            cfg.box_off)

    with span("train/rpn"):
        logits, deltas = model.rpn(feats_l, feats_r)
        rpn_l = rpn_losses(logits, deltas, at)

    with span("train/targets"):
        # Proposals feed the second stage as constants (no grad through
        # boxes).
        props = select_proposals(logits.detach(), deltas.detach(), anchors,
                                 im_h, im_w, cfg.rpn, True, cfg.box_off)
        rt = proposal_targets(props.left, props.right, props.valid, gt,
                              cfg.rcnn, uniforms.roi_fg, uniforms.roi_bg,
                              uniforms.roi_take, cfg.box_off)
    if evidence is not None:
        evidence.update(left=props.left.detach(),
                        right=props.right.detach(), valid=props.valid,
                        num_fg_rpn=at.num_fg, num_fg_rcnn=rt.num_fg,
                        anchor_weights=at.weights, rois_left=rt.rois_left,
                        roi_weights=rt.weights)

    with span("train/roi_align"):
        pooled = roi_features(model, feats_l, feats_r, rt.rois_left,
                              rt.rois_right)

    with span("train/heads"):
        outs = model.heads(pooled["concat"])
        kpt_logits = model.keypoints(pooled["left_kpt"])
        s = cfg.rcnn.rois_per_image
        outs = type(outs)(*[x.reshape(b, s, *x.shape[1:]) for x in outs])
        kpt_logits = kpt_logits.reshape(b, s, *kpt_logits.shape[1:])
        rc_l = rcnn_losses(outs, kpt_logits, rt, cfg.rcnn.kpt_softmax)

    losses = {k: v.mean() for k, v in {**rpn_l, **rc_l}.items()}
    losses["num_fg_rpn"] = at.num_fg.float().mean()
    losses["num_fg_rcnn"] = rt.num_fg.float().mean()
    return losses


def _place(state: TrainState, batch: Batch, device: torch.device) -> Batch:
    """Move ``state`` (in place) and ``batch`` (numpy or tensors) to
    ``device``."""
    if next(state.model.parameters()).device != device:
        state.model.to(device)
        state.uncert = state.uncert.detach().to(device).requires_grad_(True)
        state.trace = {k: v.to(device) for k, v in state.trace.items()}

    return Batch(torch.as_tensor(batch.images_left, device=device),
                 torch.as_tensor(batch.images_right, device=device),
                 ground_truth_to_torch(batch.gt, device))


def step_generator(seed: int, step: int,
                   device: torch.device | str) -> torch.Generator:
    """The target-sampling generator of training step ``step`` on
    ``device``: seeded from ``(seed, step)`` alone, so a run resumed from a
    checkpoint draws what an uninterrupted run draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) % (1 << 63))
    return gen


def make_train_step(cfg: Config, steps_per_epoch: int = 1000,
                    device: torch.device | str | None = None):
    """``step_fn(state, batch, generator=None, uniforms=None, rows=None,
    reduce_grads=None, evidence=None) -> metrics``: one step on ``state``
    in place (its parameters, traces and step count), with the state and
    batch on ``device`` (default: the CUDA card).  ``generator`` (on that
    device) draws the target sampling's uniforms unless ``uniforms`` gives
    them; ``rows`` places the batch in a global one and ``evidence`` gets
    the step's proposals and foreground counts (:func:`compute_losses`).
    ``reduce_grads(params)``, if given, runs between the backward and the
    optimizer (``parallel.data_parallel_train_step`` averages the
    gradients over the ranks there).  Metrics are 0-dim tensors with the
    JAX package's keys."""
    device = resolve_device(device)
    update, schedule = make_optimizer(cfg, steps_per_epoch)

    def step_fn(state: TrainState, batch: Batch,
                generator: torch.Generator | None = None,
                uniforms: Uniforms | None = None,
                rows: Tuple[int, int] | None = None,
                reduce_grads: Callable | None = None,
                evidence: Dict[str, torch.Tensor] | None = None
                ) -> Dict[str, torch.Tensor]:
        batch = _place(state, batch, device)
        params = trainable_params(state)
        for p in params.values():
            p.grad = None
        with span("train/losses"):
            losses = compute_losses(state.model, batch, cfg, generator,
                                    uniforms, rows, evidence)
            total = combine_with_uncertainty(losses, state.uncert)
        with span("train/backward"):
            total.backward()
        if reduce_grads is not None:
            with span("train/all_reduce"):
                reduce_grads(params)
        with span("train/optimizer"):
            g_norm = update(params, state.trace, state.step)
        metrics = {**{k: v.detach() for k, v in losses.items()},
                   "total": total.detach(),
                   "lr": torch.tensor(schedule(state.step)),
                   "grad_norm": g_norm}
        uncert = state.uncert.detach()
        metrics.update({f"uncert_{k}": uncert[i]
                        for i, k in enumerate(LOSS_NAMES)})
        state.step += 1
        return metrics

    return step_fn
