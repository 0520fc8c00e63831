"""Weights of one configuration, made on the card from the seed.

Every weight is drawn in one call (a ``torch.Generator`` on the device),
then each leaf is a scaled slice of the draw: convolution and linear
kernels normal with variance ``1 / fan_in``, biases zero, norms identity
(GroupNorm scale 1, frozen-BN scale 1, biases 0).  The heads' output layers are
drawn as a trained detector's behave, so that the final decisions do not
rest on near-ties: class logits spread over a few units with about half
of the proposals cars (:func:`balance_class_head`); keypoint logits
large (one clear peak);
box deltas small (O(0.1) px) with a disparity between the left and
right boxes.  Objectness keeps the plain initialisation (std 0.01), so
proposals spread over the image.  The benchmark hands the same state
dict to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from h100_bench.reference.config import Config
from h100_bench.reference.models.detector import build_model

#: Spread of the class-versus-background logit gaps over a pair's
#: proposals (:func:`balance_class_head`).
CLASS_LOGIT_STD = 4.0

#: Standard deviation of the output layers (the rest: ``1 / sqrt(fan_in)``).
OUTPUT_STD = {
    "RCNN_rpn.RPN_Conv.weight": 0.01,
    "RCNN_rpn.RPN_cls_score.weight": 0.01,
    "RCNN_rpn.RPN_bbox_pred.weight": 1e-4,
    "rcnn_head.RCNN_cls_score.weight": 3.0,
    "rcnn_head.RCNN_bbox_pred.weight": 1e-4,
    "rcnn_head.RCNN_dim_orien_pred.weight": 1e-3,
    "kpt_head.RCNN_kpts_score.weight": 3.0,
}

#: Biases of the output layers: (row length, index in the row, value).  The
#: box head's right-image u offset is -0.1 box widths in every class's row
#: (the raw delta times its 0.1 normalising std), so a detection's right
#: box sits left of its left box by a disparity, as a trained head puts
#: it; with no disparity the depth of every box is unobservable and the
#: 3D solve is chaotic.
OUTPUT_BIAS = {"rcnn_head.RCNN_bbox_pred.bias": (6, 4, -1.0)}


def make_state_dict(cfg: Config, seed: int,
                    device: torch.device | str) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg``'s detector drawn from ``seed`` on
    ``device`` (float32)."""
    with torch.device("meta"):
        model = build_model(cfg)
    transposed = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    drawn = [k for k, s in shapes.items()
             if k.endswith("weight") and len(s) >= 2]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn),
                       generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        if key in drawn:
            n = math.prod(shape)
            std = (OUTPUT_STD.get(key) if key in OUTPUT_STD else
                   1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
                   if key in transposed else
                   1.0 / math.sqrt(math.prod(shape[1:])))
            out[key] = flat[at:at + n].view(shape) * std
            at += n
        elif key.endswith(("gn.weight", ".scale")):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    for key, (step, index, value) in OUTPUT_BIAS.items():
        out[key].view(-1, step)[:, index] = value
    return out


def balance_class_head(cfg: Config, state_dict: Dict[str, torch.Tensor],
                       left: torch.Tensor, right: torch.Tensor):
    """``(scale, bias)`` for the class kernel: the factor that gives the
    class-versus-background logit gaps of one pair's proposals a spread
    of :data:`CLASS_LOGIT_STD`, and the bias ``[K]`` that puts the median
    proposal on the decision boundary.  The class kernel's inputs follow
    a ReLU and share one large positive component, so without the bias a
    seed's boxes are nearly all cars or nearly none; with the scale the
    scores are spread over (0, 1), and the final top-k ranks by class
    score, not by proposal order.  Computed by the reference in float32
    on the pair ``left``, ``right`` ([1, H, W, 3] on the weights'
    device)."""
    import dataclasses
    from h100_bench.reference import precision
    from h100_bench.reference.models.detector import forward_raw
    rcfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, remat=False),
        rcnn=dataclasses.replace(cfg.rcnn, roi_align_hat="f32"))
    with torch.device("meta"):
        model = build_model(rcfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    with precision.float32(), torch.no_grad():
        raw = forward_raw(model.eval(), left, right)
    logits = raw["rcnn"].cls_logits[0][raw["proposals"].valid[0]]
    gaps = logits[:, 1:] - logits[:, :1]
    scale = CLASS_LOGIT_STD / gaps.std().clamp(min=1e-30)
    bias = torch.zeros(logits.shape[-1], device=logits.device)
    bias[1:] = -(gaps * scale).median(dim=0).values
    return scale, bias


def apply_class_head(state_dict: Dict[str, torch.Tensor], scale, bias):
    """``state_dict`` with the class kernel scaled and biased."""
    w, b = "rcnn_head.RCNN_cls_score.weight", "rcnn_head.RCNN_cls_score.bias"
    out = dict(state_dict)
    out[w] = state_dict[w] * scale.to(state_dict[w].device)
    out[b] = state_dict[b] * scale.to(state_dict[b].device) + bias.to(
        state_dict[b].device)
    return out
