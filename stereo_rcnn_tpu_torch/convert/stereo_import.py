"""Released Stereo R-CNN checkpoint -> the port's ``state_dict`` (every
head, not just the backbone), without JAX.

Port of ``stereo_rcnn_tpu.convert.stereo_import``.  The port's parameters
already carry the upstream names, so what is left is the reference's
module names (the name tables below, as the JAX module has them; if a real
checkpoint spells a name otherwise, only these tables change), the
``RCNN_layerN`` backbone prefixes (:func:`split_backbone_names`), and
BatchNorm folded into the frozen BN's ``scale``/``bias``
(``resnet_import._fold_bn``).  Layouts stay torch's: OIHW convolutions,
``[out, in]`` linears, the ``[in, out, kh, kw]`` deconvolution, and fc6's
columns in upstream's (c, h, w) flatten order, which the port's head
flattens the same way (the JAX module permutes them to (h, w, c);
``convert/from_jax.py`` undoes that).

:func:`import_detector` reports what it matched and which keys no rule
claimed, so a run on a real checkpoint shows any naming drift.
:func:`upstream_state_dict` writes a frozen-BN model's weights the other
way, as the released checkpoint names them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from stereo_rcnn_tpu_torch.convert.resnet_import import import_resnet_backbone

# The detector checkpoint wraps the ResNet stages as RCNN_layer0
# (conv1 + bn1 + relu + maxpool) .. RCNN_layer4; import_detector also
# accepts bare torchvision names (conv1, layer1., ...).
BACKBONE_PREFIX_MAP = {
    "RCNN_layer0.0": "conv1",
    "RCNN_layer0.1": "bn1",
    **{f"RCNN_layer{i}": f"layer{i}" for i in (1, 2, 3, 4)},
}

# Upstream prefix -> the port's prefix; weights and biases are copied as
# they are.
FPN_MAP = {
    "RCNN_toplayer": "backbone_net.RCNN_toplayer",
    "RCNN_latlayer1": "backbone_net.RCNN_latlayer1",
    "RCNN_latlayer2": "backbone_net.RCNN_latlayer2",
    "RCNN_latlayer3": "backbone_net.RCNN_latlayer3",
    "RCNN_smooth1": "backbone_net.RCNN_smooth1",
    "RCNN_smooth2": "backbone_net.RCNN_smooth2",
    "RCNN_smooth3": "backbone_net.RCNN_smooth3",
}

RPN_MAP = {
    "RCNN_rpn.RPN_Conv": "RCNN_rpn.RPN_Conv",
    "RCNN_rpn.RPN_cls_score": "RCNN_rpn.RPN_cls_score",
    # The stereo 6-tuple box head; upstream sometimes spells it with the
    # left_right suffix: both accepted.
    "RCNN_rpn.RPN_bbox_pred": "RCNN_rpn.RPN_bbox_pred",
    "RCNN_rpn.RPN_bbox_pred_left_right": "RCNN_rpn.RPN_bbox_pred",
}

HEAD_MAP = {
    "RCNN_fc6": "rcnn_head.RCNN_fc6",
    "RCNN_fc7": "rcnn_head.RCNN_fc7",
    "RCNN_cls_score": "rcnn_head.RCNN_cls_score",
    "RCNN_bbox_pred": "rcnn_head.RCNN_bbox_pred",
    "RCNN_dim_orien_pred": "rcnn_head.RCNN_dim_orien_pred",
    # Keypoint branch (names uncertain: single place to fix).
    "RCNN_kpts_conv1": "kpt_head.RCNN_kpts_conv1",
    "RCNN_kpts_conv2": "kpt_head.RCNN_kpts_conv2",
    "RCNN_kpts_deconv": "kpt_head.RCNN_kpts_deconv",
    "RCNN_kpts_score": "kpt_head.RCNN_kpts_score",
}


def split_backbone_names(sd: Mapping[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Rewrite RCNN_layerN-prefixed backbone keys to torchvision-style names
    that :func:`import_resnet_backbone` understands; bare names pass
    through."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        for pref, repl in BACKBONE_PREFIX_MAP.items():
            if k.startswith(pref + "."):
                out[repl + k[len(pref):]] = v
                break
        else:
            if k.startswith(("conv1.", "bn1.", "layer")):
                out[k] = v
    return out


def import_detector(sd: Mapping[str, np.ndarray], depth: int = 101,
                    pool: int = 7, fpn_dim: int = 256
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Convert a full reference detector ``state_dict`` (numpy values) to
    the port's names and forms.

    Returns ``(state_dict, report)``: float32 tensors under the port's
    names (for ``StereoRCNN.load_state_dict``, or
    ``resnet_import.load_into`` where it is partial), and ``{"matched": [...],
    "unclaimed": [...]}``, the upstream prefixes converted and the keys no
    rule claimed.  ``pool`` and ``fpn_dim`` check fc6's width."""
    out: Dict[str, np.ndarray] = {}
    matched: list = []
    claimed: set = set()

    bb_sd = split_backbone_names(sd)
    if "conv1.weight" in bb_sd:
        out.update(import_resnet_backbone(bb_sd, depth=depth))
        matched.append("<backbone stages>")
        for k in sd:
            for pref in list(BACKBONE_PREFIX_MAP) + ["conv1", "bn1",
                                                     "layer"]:
                if k.startswith(pref):
                    claimed.add(k)
                    break

    for prefix, ours in {**FPN_MAP, **RPN_MAP, **HEAD_MAP}.items():
        if f"{prefix}.weight" not in sd:
            continue
        weight = np.asarray(sd[f"{prefix}.weight"], np.float32)
        if (prefix == "RCNN_fc6" and
                weight.shape[1] != 2 * fpn_dim * pool * pool):
            raise ValueError(f"{prefix}.weight has {weight.shape[1]} input "
                             f"columns, not 2 x {fpn_dim} x {pool} x {pool}")
        out[f"{ours}.weight"] = weight
        if f"{prefix}.bias" in sd:
            out[f"{ours}.bias"] = np.asarray(sd[f"{prefix}.bias"],
                                             np.float32)
        matched.append(prefix)
        claimed.add(f"{prefix}.weight")
        claimed.add(f"{prefix}.bias")

    unclaimed = [k for k in sd if k not in claimed]
    return ({k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in out.items()},
            {"matched": matched, "unclaimed": unclaimed})


def upstream_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A frozen-BN model's weights under the released upstream checkpoint's
    names, as :func:`import_detector` reads them: the port's container
    prefixes dropped, and each frozen BN (``scale``, ``bias``) written as a
    BatchNorm of that weight and bias with mean 0 and variance 1.  CPU
    tensors."""
    out = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu().clone()
        for prefix in ("backbone_net.", "rcnn_head.", "kpt_head."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.endswith(".scale"):
            stem = k[:-len(".scale")]
            out[stem + ".weight"] = v
            out[stem + ".running_mean"] = torch.zeros_like(v)
            out[stem + ".running_var"] = torch.ones_like(v)
        else:
            out[k] = v
    return out
