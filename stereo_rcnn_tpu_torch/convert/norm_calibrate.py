"""Calibrate a GroupNorm-trained model into the frozen-affine inference
model.

Port of ``stereo_rcnn_tpu.convert.norm_calibrate``.  From-scratch training
at depth 101 needs GroupNorm (``synthetic_fullres_config()``), whose
per-sample statistics cost time at inference.  Calibration freezes each
GroupNorm site's normalizer at the expected statistics over a calibration
set, which turns the site into the per-channel affine of the frozen-BN
model (``backbone.norm="frozen"``):

    scale_c = gamma_c / sqrt(E[var_g(c)] + eps)
    bias_c  = beta_c - E[mu_g(c)] * scale_c

The JAX package captures the statistics with flax's ``sow``; here a
forward pre-hook on each ``GroupNorm32`` takes the moments of its input,
in float32, grouped as GroupNorm groups the channels, pooled over the
batch by the law of total variance and repeated over each group's
channels (``stereo_rcnn_tpu/models/resnet_fpn.py:50-64``).  With one
calibration image the expectations are that image's own statistics, so
the calibrated backbone reproduces the GroupNorm one on it.
``tools.calibrate_norm`` validates the approximation on held-out scenes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

from stereo_rcnn_tpu_torch.models.detector import StereoRCNN, build_model
from stereo_rcnn_tpu_torch.models.resnet_fpn import GroupNorm32

# flax.linen.GroupNorm's default epsilon, which GroupNorm32 keeps.
_GN_EPS = 1e-6


def _site_moments(x: torch.Tensor, groups: int):
    """Per-channel ``(mu, var)`` [C] of one batch of a site's NCHW input,
    pooled over the batch (total variance = E[var_g] + Var[mu_g])."""
    n, c, h, w = x.shape
    xg = x.permute(0, 2, 3, 1).float().reshape(n, h * w, groups, c // groups)
    mu = xg.mean(dim=(1, 3))                                   # [n, g]
    var = ((xg - mu[:, None, :, None]) ** 2).mean(dim=(1, 3))
    rep = c // groups
    return (mu.mean(0).repeat_interleave(rep),
            (var.mean(0) + mu.var(0, unbiased=False)).repeat_interleave(rep))


@torch.no_grad()
def capture_norm_stats(model: StereoRCNN,
                       batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run the backbone over calibration batches and average each
    GroupNorm site's moments.

    ``batches``: (images_left, images_right) NHWC tensors on the model's
    device; both views share the backbone, so both contribute.  Returns
    ``{site: {"mu": [C], "var": [C]}}``, the site being the norm module's
    name in the model (``backbone_net.RCNN_layer1.0.bn1``).
    """
    sums: Dict[str, Dict[str, torch.Tensor]] = {}

    def hook(name, groups):
        def fn(_module, inputs):
            mu, var = _site_moments(inputs[0], groups)
            if name in sums:
                sums[name]["mu"] += mu
                sums[name]["var"] += var
            else:
                sums[name] = {"mu": mu, "var": var}
        return fn

    handles = [m.register_forward_pre_hook(hook(name, m.gn.num_groups))
               for name, m in model.named_modules()
               if isinstance(m, GroupNorm32)]
    n = 0
    try:
        for il, ir in batches:
            for im in (il, ir):
                model.backbone(im)
                n += 1
    finally:
        for h in handles:
            h.remove()
    return {site: {k: v / n for k, v in s.items()}
            for site, s in sums.items()}


def fold_group_norms(group_state: Dict[str, torch.Tensor],
                     norm_stats: Dict[str, Dict[str, torch.Tensor]],
                     affine_template: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A frozen-affine ``state_dict`` from a GroupNorm one and the stats.

    ``group_state`` / ``affine_template``: ``state_dict``s of the same
    config built with ``norm="group"`` and ``norm="frozen"``.  They hold
    the same tensors except at norm sites, where the group model has
    ``<site>.gn.weight``/``.gn.bias`` and the frozen one ``<site>.scale``/
    ``.bias``.  Other tensors are copied as they are.  A site without
    statistics raises ``KeyError``.
    """
    out = {}
    for key, tmpl in affine_template.items():
        site, _, leaf = key.rpartition(".")
        if f"{site}.gn.weight" in group_state and leaf in ("scale", "bias"):
            if site not in norm_stats:
                raise KeyError(f"no calibration stats for norm site {site}")
            gamma = group_state[f"{site}.gn.weight"]
            beta = group_state[f"{site}.gn.bias"]
            stats = norm_stats[site]
            # gamma / sqrt(var + eps) as XLA computes it (and as
            # GroupNorm32 normalises): a multiply by the reciprocal root.
            inv = gamma * torch.rsqrt(stats["var"] + _GN_EPS)
            value = inv if leaf == "scale" else beta - stats["mu"] * inv
        else:
            value = group_state[key]
            if value.shape != tmpl.shape:
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{tuple(value.shape)} vs "
                                 f"{tuple(tmpl.shape)}")
        out[key] = value.to(tmpl.dtype)
    return out


def calibrate(cfg, group_model: StereoRCNN,
              batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]):
    """Capture the stats of ``group_model`` (``cfg``, ``norm="group"``)
    and return ``(cfg_aff, affine_model)``: ``cfg`` with
    ``backbone.norm="frozen"`` and its model, in eval mode on the group
    model's device, holding the folded weights."""
    stats = capture_norm_stats(group_model, batches)
    cfg_aff = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, norm="frozen"))
    dev = next(group_model.parameters()).device
    affine = build_model(cfg_aff).to(dev)
    affine.load_state_dict(fold_group_norms(
        group_model.state_dict(), stats, affine.state_dict()), strict=True)
    return cfg_aff, affine.eval()
