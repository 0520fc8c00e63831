"""Detection losses and the learned multi-task uncertainty weighting (torch).

Port of ``stereo_rcnn_tpu.train.losses``.  The JAX functions take one
image and are vmapped; these take any leading batch dims and reduce the
last axis (anchors or sampled rois), so ``[A]`` inputs give the JAX
function's scalars and ``[B, A]`` inputs give one value per image.
"""

from __future__ import annotations

from typing import Dict

import torch

from stereo_rcnn_tpu_torch.models.heads import RCNNOutputs
from stereo_rcnn_tpu_torch.train.targets import AnchorTargets, RoiTargets

LOSS_NAMES = ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "dim_orien",
              "kpt")


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber/smooth-L1 (reference: net_utils._smooth_l1_loss, sigma form)."""
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad ** 2 / beta, ad - 0.5 * beta)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def rpn_losses(logits: torch.Tensor, deltas: torch.Tensor,
               tgt: AnchorTargets) -> Dict[str, torch.Tensor]:
    """logits [..., A, 2], deltas [..., A, 6]."""
    labels = torch.clamp(tgt.labels, min=0)
    ce = softmax_ce(logits, labels) * tgt.weights
    n = torch.clamp(tgt.num_sampled, min=1.0)
    cls_loss = ce.sum(-1) / n

    fg = ((tgt.labels == 1) & (tgt.weights > 0)).float()
    box = smooth_l1(deltas - tgt.box_targets, beta=1.0 / 9.0).sum(-1) * fg
    # The reference normalises by the full sampled anchor batch.
    box_loss = box.sum(-1) / n
    return {"rpn_cls": cls_loss, "rpn_box": box_loss}


def _at_class(x: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """x [..., S, K, D] at each row's class -> [..., S, D]."""
    idx = cls.long()[..., None, None].expand(*cls.shape, 1, x.shape[-1])
    return torch.gather(x, -2, idx)[..., 0, :]


def rcnn_losses(out: RCNNOutputs, kpt_logits: torch.Tensor,
                tgt: RoiTargets,
                kpt_softmax: str = "joint") -> Dict[str, torch.Tensor]:
    """Head losses over the S sampled rois; kpt_logits [..., S, 6, G].
    ``kpt_softmax``: "joint" = one CE over the flattened 4*G bins;
    "per_channel" = CE over G bins on the GT corner's channel only."""
    w = tgt.weights
    n = torch.clamp(w.sum(-1), min=1.0)
    cls_loss = (softmax_ce(out.cls_logits, tgt.cls) * w).sum(-1) / n

    fg = (tgt.cls > 0).float() * w
    nfg = torch.clamp(fg.sum(-1), min=1.0)
    box_pred = _at_class(out.box_deltas, tgt.cls)
    box_loss = (smooth_l1(box_pred - tgt.box_targets).sum(-1) *
                fg).sum(-1) / nfg

    dim_l = smooth_l1(_at_class(out.dims, tgt.cls) -
                      tgt.dim_targets).sum(-1)
    ori_l = smooth_l1(_at_class(out.orien, tgt.cls) -
                      tgt.orien_targets).sum(-1)
    dim_orien_loss = ((dim_l + ori_l) * fg).sum(-1) / nfg

    g = kpt_logits.shape[-1]
    persp = kpt_logits[..., :4, :]
    if kpt_softmax == "joint":
        kpt_ce = softmax_ce(persp.reshape(*persp.shape[:-2], 4 * g),
                            tgt.kpt_bin) * tgt.kpt_weight
    elif kpt_softmax == "per_channel":
        chan = _at_class(persp, tgt.kpt_bin // g)              # [..., S, G]
        kpt_ce = softmax_ce(chan, tgt.kpt_bin % g) * tgt.kpt_weight
    else:
        raise ValueError(f"rcnn.kpt_softmax: unknown mode {kpt_softmax!r} "
                         "(expected 'joint' or 'per_channel')")
    b_ce = (softmax_ce(kpt_logits[..., 4, :], tgt.border_bins[..., 0]) +
            softmax_ce(kpt_logits[..., 5, :], tgt.border_bins[..., 1])) \
        * tgt.border_weight
    denom = torch.clamp(tgt.kpt_weight.sum(-1) + tgt.border_weight.sum(-1),
                        min=1.0)
    kpt_loss = (kpt_ce.sum(-1) + b_ce.sum(-1)) / denom

    return {"rcnn_cls": cls_loss, "rcnn_box": box_loss,
            "dim_orien": dim_orien_loss, "kpt": kpt_loss}


def combine_with_uncertainty(losses: Dict[str, torch.Tensor],
                             uncert: torch.Tensor) -> torch.Tensor:
    """total = sum_i loss_i * exp(-s_i) + s_i   (trainval_net.py)."""
    stacked = torch.stack([losses[k] for k in LOSS_NAMES])
    return (stacked * torch.exp(-uncert) + uncert).sum()
