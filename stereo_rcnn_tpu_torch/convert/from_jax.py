"""JAX parameter tree -> the port's ``state_dict``, exactly.

The inverse of ``stereo_rcnn_tpu.convert.stereo_import.import_detector``
on the port's layouts: HWIO conv kernels -> OIHW, Dense kernels
transposed, fc6 columns from the JAX (h, w, c) flatten back to upstream's
(c, h, w), the ConvTranspose kernel ``[kh, kw, out, in]`` -> torch's
``[in, out, kh, kw]``, frozen or affine BN ``scale``/``bias`` as they are,
a GroupNorm's ``<site>/gn/{scale,bias}`` as ``<site>.gn.{weight,bias}``.
A training state's tree (``{"model": ..., "uncert": [6]}``) also gives
``"uncert"``.  Values are copied bit for bit; a leaf no rule maps raises.

Input is the flax tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from stereo_rcnn_tpu_torch.config import Config

# flax module path -> (port state_dict prefix, kind).
_FIXED = {
    "backbone_net/conv1": ("backbone_net.RCNN_layer0.0", "conv"),
    "backbone_net/bn1": ("backbone_net.RCNN_layer0.1", "bn"),
    "backbone_net/fpn_top": ("backbone_net.RCNN_toplayer", "conv"),
    "backbone_net/fpn_lat4": ("backbone_net.RCNN_latlayer1", "conv"),
    "backbone_net/fpn_lat3": ("backbone_net.RCNN_latlayer2", "conv"),
    "backbone_net/fpn_lat2": ("backbone_net.RCNN_latlayer3", "conv"),
    "backbone_net/fpn_smooth4": ("backbone_net.RCNN_smooth1", "conv"),
    "backbone_net/fpn_smooth3": ("backbone_net.RCNN_smooth2", "conv"),
    "backbone_net/fpn_smooth2": ("backbone_net.RCNN_smooth3", "conv"),
    "rpn_head/rpn_conv": ("RCNN_rpn.RPN_Conv", "conv"),
    "rpn_head/rpn_cls": ("RCNN_rpn.RPN_cls_score", "conv"),
    "rpn_head/rpn_box": ("RCNN_rpn.RPN_bbox_pred", "conv"),
    "rcnn_head/fc6": ("rcnn_head.RCNN_fc6", "fc6"),
    "rcnn_head/fc7": ("rcnn_head.RCNN_fc7", "linear"),
    "rcnn_head/cls_score": ("rcnn_head.RCNN_cls_score", "linear"),
    "rcnn_head/bbox_pred": ("rcnn_head.RCNN_bbox_pred", "linear"),
    "rcnn_head/dim_orien_pred": ("rcnn_head.RCNN_dim_orien_pred", "linear"),
    "kpt_head/kpt_conv1": ("kpt_head.RCNN_kpts_conv1", "conv"),
    "kpt_head/kpt_conv2": ("kpt_head.RCNN_kpts_conv2", "conv"),
    "kpt_head/kpt_deconv": ("kpt_head.RCNN_kpts_deconv", "deconv"),
    "kpt_head/kpt_score": ("kpt_head.RCNN_kpts_score", "conv"),
}

# Bottleneck children: flax name -> (port suffix, kind).
_BLOCK = {
    "conv1": ("conv1", "conv"), "conv2": ("conv2", "conv"),
    "conv3": ("conv3", "conv"), "bn1": ("bn1", "bn"), "bn2": ("bn2", "bn"),
    "bn3": ("bn3", "bn"), "downsample_conv": ("downsample.0", "conv"),
    "downsample_bn": ("downsample.1", "bn"),
}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _module_rule(path: str):
    """(port prefix, kind) for a flax module path, or None."""
    site, _, last = path.rpartition("/")
    if last == "gn":                      # GroupNorm under a norm site
        rule = _module_rule(site)
        if rule is None or rule[1] != "bn":
            return None
        return f"{rule[0]}.gn", "gn"
    if path in _FIXED:
        return _FIXED[path]
    parts = path.split("/")
    if (len(parts) == 3 and parts[0] == "backbone_net"
            and parts[1].startswith("layer") and parts[2] in _BLOCK):
        stage, block = parts[1][len("layer"):].split("_")
        suffix, kind = _BLOCK[parts[2]]
        return f"backbone_net.RCNN_layer{stage}.{block}.{suffix}", kind
    return None


def _convert(kind: str, leaf: str, x: np.ndarray, pool: int,
             channels: int) -> tuple[str, np.ndarray]:
    if kind == "bn":                      # frozen/affine BN, as they are
        return leaf, x
    if kind == "gn":                      # flax scale -> torch weight
        return ("weight" if leaf == "scale" else leaf), x
    if leaf == "bias":
        return "bias", x
    if kind in ("conv", "deconv"):
        # conv: HWIO -> OIHW; deconv: [kh, kw, out, in] -> [in, out, kh, kw].
        # The same axis permutation.
        return "weight", x.transpose(3, 2, 0, 1)
    if kind == "linear":                  # [in, out] -> [out, in]
        return "weight", x.T
    if kind == "fc6":                     # rows (h, w, c) -> columns (c, h, w)
        w = x.T
        d_out = w.shape[0]
        w = w.reshape(d_out, pool, pool, channels).transpose(0, 3, 1, 2)
        return "weight", w.reshape(d_out, -1)
    raise ValueError(kind)


def state_dict_from_jax(params_np: Mapping, cfg: Config
                        ) -> Dict[str, torch.Tensor]:
    """Map every leaf of the flax tree (with or without its top-level
    ``"params"`` key, or a training state's ``{"model", "uncert"}``) to
    the port's ``state_dict``, plus ``"uncert"`` for a training state."""
    tree = params_np["params"] if "params" in params_np else params_np
    out: Dict[str, torch.Tensor] = {}
    if "uncert" in tree:
        out["uncert"] = torch.from_numpy(
            np.array(tree["uncert"], dtype=np.float32, order="C"))
        tree = {k: v for k, v in tree.items() if k != "uncert"}
        if set(tree) == {"model"}:
            tree = tree["model"]
    pool = cfg.rcnn.pooling_size
    channels = 2 * cfg.backbone.fpn_dim
    unmapped = []
    for path, x in _flatten(tree).items():
        module, leaf = path.rsplit("/", 1)
        rule = _module_rule(module)
        if rule is None or leaf not in ("kernel", "bias", "scale"):
            unmapped.append(path)
            continue
        prefix, kind = rule
        name, value = _convert(kind, leaf, x, pool, channels)
        out[f"{prefix}.{name}"] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    if unmapped:
        raise KeyError(f"no rule maps these JAX leaves: {unmapped}")
    return out
