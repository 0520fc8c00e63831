"""PyTorch ResNet ``state_dict`` -> the port's backbone ``state_dict``.

Port of ``stereo_rcnn_tpu.convert.resnet_import``.  The reference loads
``resnet101_caffe.pth`` and the released detector checkpoint with
``load_state_dict``; the port's convolutions are torch's, so kernels keep
their OIHW layout, and only BatchNorm changes form: its four tensors fold
into the port's frozen BN constants

    scale = gamma / sqrt(var + eps),  bias = beta - mean * scale.

Handles the torchvision/caffe ResNet names: ``conv1.weight``,
``bn1.{weight,bias,running_mean,running_var}``, ``layerL.B.convK.weight``,
``layerL.B.bnK.*``, ``layerL.B.downsample.{0,1}.*``.  Input and output
values are numpy arrays (``{k: v.numpy() for k, v in sd.items()}``);
:func:`load_into` puts converted tensors into a model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from stereo_rcnn_tpu_torch.models.resnet_fpn import STAGE_BLOCKS

BN_EPS = 1e-5


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    gamma = np.asarray(sd[f"{prefix}.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": scale, "bias": beta - mean * scale}


def _conv(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    # The port's convolutions keep torch's OIHW layout.
    return {"weight": np.asarray(sd[name], np.float32)}


def _put(out: Dict[str, np.ndarray], prefix: str,
         leaves: Mapping[str, np.ndarray]) -> None:
    for leaf, value in leaves.items():
        out[f"{prefix}.{leaf}"] = value


def import_resnet_backbone(state_dict: Mapping[str, np.ndarray],
                           depth: int = 101) -> Dict[str, np.ndarray]:
    """Convert a torch ResNet ``state_dict`` (numpy values) to the port's
    names under ``backbone_net.`` (stem and stages only: the FPN layers
    are left out)."""
    sd = state_dict
    out: Dict[str, np.ndarray] = {}
    _put(out, "backbone_net.RCNN_layer0.0", _conv(sd, "conv1.weight"))
    _put(out, "backbone_net.RCNN_layer0.1", _fold_bn(sd, "bn1"))
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth], start=1):
        for b in range(n_blocks):
            t = f"layer{stage}.{b}"
            ours = f"backbone_net.RCNN_layer{stage}.{b}"
            for k in (1, 2, 3):
                _put(out, f"{ours}.conv{k}", _conv(sd, f"{t}.conv{k}.weight"))
                _put(out, f"{ours}.bn{k}", _fold_bn(sd, f"{t}.bn{k}"))
            if f"{t}.downsample.0.weight" in sd:
                _put(out, f"{ours}.downsample.0",
                     _conv(sd, f"{t}.downsample.0.weight"))
                _put(out, f"{ours}.downsample.1",
                     _fold_bn(sd, f"{t}.downsample.1"))
    return out


def load_into(model, converted: Mapping) -> list:
    """Copy converted tensors into ``model`` (the JAX package's
    ``merge_backbone_params``): every converted name must be one of the
    model's, with its shape; returns the model's names that were left as
    they were (a partial conversion such as the backbone alone)."""
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(np.ascontiguousarray(v))
         for k, v in converted.items()}, strict=False)
    if unexpected:
        raise KeyError(f"names the model does not have: {unexpected[:5]}")
    return missing
