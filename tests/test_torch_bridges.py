"""The port's copies and bridges pinned to the JAX package, on the CPU:
the config copy, the renderer copy, and the weight converter.

Exact comparisons throughout: these are copies, not re-implementations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import config as j_config
from stereo_rcnn_tpu.convert.resnet_import import _fold_bn
from stereo_rcnn_tpu.convert.stereo_import import import_detector
from stereo_rcnn_tpu.data.synthetic import synthetic_batch
from stereo_rcnn_tpu_torch import config as t_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.models.detector import StereoRCNN

from tests.test_convert_full import DEPTH, FPN_DIM, TorchStereoRCNN


@pytest.mark.parametrize("make", ["Config", "tiny_test_config"])
def test_config_copy_matches(make):
    ours = getattr(t_config, make)()
    theirs = getattr(j_config, make)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.box_off == theirs.box_off


def test_renderer_copy_is_byte_identical():
    cfg_t = t_config.tiny_test_config()
    cfg_j = j_config.tiny_test_config()
    il_t, ir_t, calib_t = synthetic_images(cfg_t, 3, seed=7, n_objects=5)
    il_j, ir_j, _, calib_j = synthetic_batch(cfg_j, batch=3, seed=7,
                                             n_objects=5)
    assert il_t.dtype == il_j.dtype == np.float32
    np.testing.assert_array_equal(il_t, il_j)
    np.testing.assert_array_equal(ir_t, ir_j)
    for a, b in zip(calib_t, calib_j):
        np.testing.assert_array_equal(a, b)


def _strip(key):
    """Port key -> upstream key (the port nests three containers)."""
    for pref in ("backbone_net.", "rcnn_head.", "kpt_head."):
        if key.startswith(pref):
            return key[len(pref):]
    return key


@pytest.fixture(scope="module")
def twin_round_trip():
    torch.manual_seed(0)
    twin = TorchStereoRCNN()
    for mod in twin.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.normal_(0, 0.5)
            mod.running_var.uniform_(0.5, 2.0)
            mod.weight.data.uniform_(0.5, 1.5)
            mod.bias.data.normal_(0, 0.5)
    sd = {k: v.detach().numpy() for k, v in twin.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, report = import_detector(sd, depth=DEPTH, pool=7,
                                     fpn_dim=FPN_DIM)
    assert report["unclaimed"] == []
    base = t_config.tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, depth=DEPTH,
                                           fpn_dim=FPN_DIM, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    return sd, state_dict_from_jax(params, cfg), cfg


def test_from_jax_round_trip_returns_the_twin_tensors(twin_round_trip):
    """twin state_dict -> import_detector -> from_jax gives back the twin's
    tensors bit for bit; BatchNorm comes back as its folded constants."""
    sd, ours, _ = twin_round_trip
    bn_prefixes = {k[:-len(".running_mean")] for k in sd
                   if k.endswith(".running_mean")}
    seen = set()
    for key, value in ours.items():
        up = _strip(key)
        prefix, leaf = up.rsplit(".", 1)
        if prefix in bn_prefixes:
            np.testing.assert_array_equal(value.numpy(),
                                          _fold_bn(sd, prefix)[leaf], key)
            seen.update(f"{prefix}.{n}" for n in
                        ("weight", "bias", "running_mean", "running_var"))
        else:
            np.testing.assert_array_equal(value.numpy(), sd[up], key)
            seen.add(up)
    assert seen == set(sd)


def test_from_jax_names_match_the_port_model(twin_round_trip):
    _, ours, cfg = twin_round_trip
    assert set(ours) == set(StereoRCNN(cfg).state_dict())


def test_from_jax_raises_on_unmapped_leaf(twin_round_trip):
    sd, _, cfg = twin_round_trip
    params, _ = import_detector(sd, depth=DEPTH, pool=7, fpn_dim=FPN_DIM)
    params["rcnn_head"]["extra_head"] = {"kernel": np.zeros((2, 2),
                                                            np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)


@pytest.mark.parametrize("section, field, value", [
    ("rcnn", "roi_align_impl", "xla"),
    ("rcnn", "roi_align_hat", "kron_bf16"),
    ("backbone", "norm", "group"),
])
def test_unported_options_raise(section, field, value):
    """Options the port does not implement raise instead of running
    something else."""
    base = t_config.tiny_test_config()
    cfg = dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    with pytest.raises(NotImplementedError, match=field):
        StereoRCNN(cfg)
