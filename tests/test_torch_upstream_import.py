"""The port's JAX-free import of an upstream Stereo R-CNN ``state_dict``
(``convert/stereo_import.py``, ``convert/resnet_import.py``), on the CPU.

On the torch twin of the whole detector with the reference's names
(``tests/test_convert_full.py``, BatchNorm statistics randomised as in
``tests/test_torch_bridges.py``), the port's ``import_detector`` must give
exactly ``state_dict_from_jax`` of the JAX ``import_detector``'s tree (the
same numpy BN fold; every layout change the JAX side makes, ``from_jax``
undoes), with the same report; and the port's ``upstream_state_dict``
must give back a model's own weights through it.  Exact comparisons
throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.convert import stereo_import as j_import
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert import resnet_import, stereo_import
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.convert.stereo_import import upstream_state_dict
from stereo_rcnn_tpu_torch.models.detector import StereoRCNN
from stereo_rcnn_tpu_torch.models.heads import KeypointHead

from tests.test_convert_full import (DEPTH, FC_DIM, FPN_DIM, KPT_DIM,
                                     TorchStereoRCNN)


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(0)
    net = TorchStereoRCNN()
    for mod in net.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.normal_(0, 0.5)
            mod.running_var.uniform_(0.5, 2.0)
            mod.weight.data.uniform_(0.5, 1.5)
            mod.bias.data.normal_(0, 0.5)
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    base = tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, depth=DEPTH,
                                           fpn_dim=FPN_DIM, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    return sd, cfg


def test_import_detector_equals_jax_import_through_from_jax(twin):
    sd, cfg = twin
    ours, report = stereo_import.import_detector(sd, depth=DEPTH, pool=7,
                                                 fpn_dim=FPN_DIM)
    params, j_report = j_import.import_detector(sd, depth=DEPTH, pool=7,
                                                fpn_dim=FPN_DIM)
    theirs = state_dict_from_jax(params, cfg)
    assert report == j_report
    assert report["unclaimed"] == []
    assert set(ours) == set(theirs) == set(StereoRCNN(cfg).state_dict())
    for k in theirs:
        assert ours[k].dtype == torch.float32, k
        assert torch.equal(ours[k], theirs[k]), k


def test_report_keeps_unknown_keys_and_the_alias(twin):
    """A key no rule claims is reported, as the JAX function reports it;
    the ``_left_right`` spelling of the RPN box head is accepted."""
    sd, _ = twin
    sd = dict(sd)
    sd["RCNN_rpn.RPN_bbox_pred_left_right.weight"] = sd.pop(
        "RCNN_rpn.RPN_bbox_pred.weight")
    sd["RCNN_rpn.RPN_bbox_pred_left_right.bias"] = sd.pop(
        "RCNN_rpn.RPN_bbox_pred.bias")
    sd["RCNN_mystery.weight"] = np.zeros(3, np.float32)
    ours, report = stereo_import.import_detector(sd, depth=DEPTH, pool=7,
                                                 fpn_dim=FPN_DIM)
    _, j_report = j_import.import_detector(sd, depth=DEPTH, pool=7,
                                           fpn_dim=FPN_DIM)
    assert report == j_report
    assert report["unclaimed"] == ["RCNN_mystery.weight"]
    np.testing.assert_array_equal(
        ours["RCNN_rpn.RPN_bbox_pred.weight"].numpy(),
        sd["RCNN_rpn.RPN_bbox_pred_left_right.weight"])


def _twin_shaped_model(cfg):
    """The port's model at the twin's head widths."""
    cfg = dataclasses.replace(
        cfg, rpn=dataclasses.replace(cfg.rpn, conv_dim=128),
        rcnn=dataclasses.replace(cfg.rcnn, fc_dim=FC_DIM))
    model = StereoRCNN(cfg)
    model.kpt_head = KeypointHead(FPN_DIM, KPT_DIM)
    return model


def test_imported_model_loads_strictly_and_backbone_alone_partially(twin):
    sd, cfg = twin
    ours, _ = stereo_import.import_detector(sd, depth=DEPTH, pool=7,
                                            fpn_dim=FPN_DIM)
    _twin_shaped_model(cfg).load_state_dict(ours, strict=True)
    # The stages alone (bare torchvision names) leave the FPN and heads.
    fresh = _twin_shaped_model(cfg)
    backbone = resnet_import.import_resnet_backbone(
        stereo_import.split_backbone_names(sd), depth=DEPTH)
    missing = resnet_import.load_into(fresh, backbone)
    assert missing and not any(k in backbone for k in missing)
    assert all(not k.startswith("backbone_net.RCNN_layer") for k in missing)
    state = fresh.state_dict()
    for k in backbone:
        assert torch.equal(state[k], ours[k]), k
    with pytest.raises(KeyError):
        resnet_import.load_into(fresh, {"backbone_net.nope": backbone[
            "backbone_net.RCNN_layer0.1.scale"]})


def test_fc6_of_another_width_is_refused(twin):
    sd, _ = twin
    with pytest.raises(ValueError, match="RCNN_fc6"):
        stereo_import.import_detector(sd, depth=DEPTH, pool=7,
                                      fpn_dim=2 * FPN_DIM)


def test_upstream_state_dict_round_trips_through_import_detector():
    """``upstream_state_dict`` of a tiny frozen-BN model, read back by
    ``import_detector``, gives the model's own ``state_dict``: every tensor
    exactly, apart from each frozen BN's scale, which the import folds
    with variance 1 as ``scale / sqrt(1 + BN_EPS)``."""
    base = tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, norm="frozen"))
    model = StereoRCNN(cfg)
    upstream = upstream_state_dict(model)
    assert not any(k.startswith(("backbone_net.", "rcnn_head.", "kpt_head."))
                   for k in upstream)
    ours, report = stereo_import.import_detector(
        upstream, depth=cfg.backbone.depth, pool=cfg.rcnn.pooling_size,
        fpn_dim=cfg.backbone.fpn_dim)
    assert report["unclaimed"] == []
    state = model.state_dict()
    assert set(ours) == set(state)
    for k, v in state.items():
        want = v.numpy()
        if k.endswith(".scale"):
            want = want / np.sqrt(np.ones_like(want) + resnet_import.BN_EPS)
        assert torch.equal(ours[k], torch.from_numpy(want)), k
